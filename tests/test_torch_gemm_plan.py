"""The launch arithmetic of the port's bf16 and int8 GEMMs, and the kernel
library's entry points, on the CPU.

The weight-gradient GEMM sums token rows in chunks, and the gelu' epilogue
writes one column partial per output tile; the wrappers size both from
constants of the CUDA sources. A split that dropped a row would drop it
from a gradient silently, and the card tests see only a few shapes, so the
plain functions of gtax_torch/kernels/backward.py are held here over a
grid of row counts and the DiT/VAE widths, with the constants read from
the sources the kernels are built from.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gtax_torch.kernels import backward, block, build, pair, quant

CSRC = Path(__file__).resolve().parent.parent / "gtax_torch" / "csrc"


def _constants():
    """(tile rows, tile columns, wide tile columns, k-step) as the kernel
    defines them."""
    head = (CSRC / "gemm_sm90.cuh").read_text()
    m = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+)", head)
    w = re.search(r"constexpr int kWideBN = (\d+);", head)
    assert m and w, "the GEMM constants moved: update this test"
    bm, bn, bk = (int(g) for g in m.groups())
    return bm, bn, int(w.group(1)), bk


TILE_M, TILE_N, WIDE_N, K_STEP = _constants()
ROWS = sorted({1, 2, 63, 64, 65, 127, 128, 129, 144, 288, 576, 720, 1000,
               1024, 1152, 1440, 2304, 3456, 5760, 11520, 11521, 16384,
               19999, 20000})
WIDTHS = [(1024, 1024), (1024, 3072), (4096, 1024), (1024, 4096),
          (64, 64), (128, 192), (512, 2048)]


def test_constants_match_the_kernel_layout():
    """The tile is two m64 warpgroups by one n128 (or n256) wgmma, and a
    k-step is one 128-byte swizzle span of bf16; the exported constants are
    these, and the weight gradient takes the wide tile where N allows."""
    assert (TILE_M, TILE_N, WIDE_N, K_STEP) == (128, 128, 256, 64)
    src = (CSRC / "gemm_bf16.cu").read_text()
    assert all(f"o[{i}] = sm90::{n};" in src
               for i, n in enumerate(("BM", "BK")))
    assert ("N % sm90::kWideBN == 0 ? sm90::kWideBN : sm90::BN"
            in (CSRC / "gemm_wgrad.cu").read_text())


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("tile_n", [TILE_N, WIDE_N])
@pytest.mark.parametrize("Ka,N", WIDTHS)
def test_wgrad_chunks_cover_every_row_once(Ka, N, tile_n, sms):
    for M in ROWS:
        splits, chunk = backward.wgrad_plan(M, Ka, N, sms, TILE_M, tile_n,
                                            K_STEP)
        assert chunk % K_STEP == 0, (M, chunk)
        assert 1 <= splits <= backward.WGRAD_MAX_SPLITS
        # the kernel's blockIdx.z = z sums rows [z * chunk, min(M, ...))
        seen = [0] * M
        for z in range(splits):
            lo, hi = z * chunk, min(M, (z + 1) * chunk)
            assert lo < hi, (M, splits, chunk, z)  # no empty chunk
            for r in range(lo, hi):
                seen[r] += 1
        assert all(c == 1 for c in seen), (M, splits, chunk)
        if splits > 1:
            assert -(-M // splits) >= backward.WGRAD_MIN_ROWS - K_STEP


@pytest.mark.parametrize("Ka,N,splits", [
    (4096, 1024, 1), (1024, 4096, 1), (1024, 1024, 4), (1024, 3072, 1)])
def test_wgrad_split_at_the_training_shapes(Ka, N, splits):
    """B=16 training (11,520 rows) on 132 SMs, wide tiles: dW_out's 32
    tiles take 4 chunks; the other three, whose 96-128 tiles come within a
    wave of the card, take one, since a split's fp32 partials (2 splits + 1
    passes over Ka x N) cost more than the SMs one chunk leaves idle. The
    plan's count is the cheapest the cost model finds."""
    got, chunk = backward.wgrad_plan(11520, Ka, N, 132, TILE_M, WIDE_N,
                                     K_STEP)
    assert got == splits
    assert chunk * got >= 11520 > chunk * (got - 1)
    costs = [backward.wgrad_cost(11520, Ka, N, 132, TILE_M, WIDE_N, K_STEP,
                                 s)[0]
             for s in range(1, backward.WGRAD_MAX_SPLITS + 1)]
    assert costs[got - 1] == min(costs)


def test_wgrad_cost_counts_the_partials():
    """One chunk writes the fp32 result once; s > 1 chunks write s partials,
    read them and write the sum (2 s + 1 passes), plus the reduce launch;
    the blocks' time falls with the chunk rows and rises with the waves."""
    Ka, N = 1024, 1024
    one = backward.wgrad_cost(11520, Ka, N, 132, TILE_M, WIDE_N, K_STEP, 1)
    two = backward.wgrad_cost(11520, Ka, N, 132, TILE_M, WIDE_N, K_STEP, 2)
    assert one[1:] == (1, 11520) and two[1:] == (2, 5760)
    pass_s = Ka * N * 4 / backward.WGRAD_PARTIAL_BYTES_PER_S
    block_s = 11520 * TILE_M * WIDE_N * 2 / backward.WGRAD_BLOCK_FLOPS
    assert one[0] == pytest.approx(block_s + pass_s)
    assert two[0] == pytest.approx(block_s / 2 + 5 * pass_s
                                   + backward.WGRAD_REDUCE_S)
    # 9 chunks of 32 tiles: 288 blocks, three waves on 132 SMs
    nine = backward.wgrad_cost(11520, Ka, N, 132, TILE_M, WIDE_N, K_STEP, 9)
    assert nine[0] > 3 * block_s / 9


@pytest.mark.parametrize("M,Ka,N,tile_n,splits", [
    (1000, 1024, 192, TILE_N, 1), (4000, 1024, 192, TILE_N, 5),
    (1000, 1024, 512, WIDE_N, 1), (4000, 1024, 512, WIDE_N, 4),
    (4000, 128, 64, TILE_N, 7),
    (288, 4096, 1024, WIDE_N, 1), (1440, 1024, 4096, WIDE_N, 1)])
def test_wgrad_split_of_the_card_tests(M, Ka, N, tile_n, splits):
    """The card tests' weight gradients (tests/test_torch_cuda.py) split as
    they say on an H100 SXM (132 SMs): one chunk, or ragged chunks whose
    last is short; the MLP backward's at 288 and 1,440 rows take one."""
    got, chunk = backward.wgrad_plan(M, Ka, N, 132, TILE_M, tile_n, K_STEP)
    assert got == splits
    assert splits == 1 or 0 < M - (splits - 1) * chunk < chunk


@pytest.mark.parametrize("N", [64, 1024, 4096])
def test_dgelu_partials_match_the_tiles_the_kernel_writes(N):
    """The gelu' epilogue of row tile y writes colsum row y; every row of
    the buffer is written, by the tile that holds rows y * TILE_M ..."""
    for M in ROWS:
        rows = backward.dgelu_partial_rows(M, TILE_M)
        grid_y = (M + TILE_M - 1) // TILE_M  # the launch's gridDim.y
        assert rows == grid_y
        written = {r // TILE_M for r in range(M)}
        assert written == set(range(rows)), (M, rows)



def _entries(names):
    """The C entry points (GTAX_ENTRY functions) the sources define."""
    return {m for n in names for m in re.findall(
        r"GTAX_ENTRY (gtax_\w+)\(", (CSRC / n).read_text())}


def test_bound_entries_are_the_defined_ones():
    """build.SIGNATURES binds each entry point the sources define, and no
    other: a stale signature would fail at load, an unbound entry could not
    be called."""
    assert set(build.SIGNATURES) == _entries(p.name for p in build.sources())


def test_probe_copy_builds_apart():
    """The probe copy (GTAX_PROBE_STOP defined) lands in a directory of its
    own, so library() never loads a kernel that stops early, and its
    sources define the entries it binds."""
    flags = build.NVCC_FLAGS
    assert build._digest(flags) != build._digest(
        (*flags, "-DGTAX_PROBE_STOP=0")) != build._digest(
        (*flags, "-DGTAX_PROBE_STOP=1"))
    assert set(build.PROBE_ENTRIES) <= _entries(build.PROBE_SOURCES)


# ------------------------------------------- the serving step's small M

def _small_constants():
    """(tile columns, row slabs) of the small-M path, and (rows, columns,
    k-step) of the int8 unit, as the kernels define them."""
    head = (CSRC / "gemm_sm90.cuh").read_text()
    n = re.search(r"constexpr int kSmallBN = (\d+);", head)
    sl = re.search(r"constexpr int kSmallSlabs = (\d+);", head)
    s8 = (CSRC / "gemm_s8.cuh").read_text()
    bn = re.search(r"constexpr int BN = (\d+);", s8)
    bk = re.search(r"constexpr int BK = (\d+);", s8)
    s8_slabs = re.search(r"constexpr int kSlabs = (\d+);", s8)
    ms = re.search(r"constexpr int kSmallMaxSplits = (\d+);", head)
    s8_ms = re.search(r"constexpr int kMaxSplits = (\d+);", s8)
    assert n and sl and bn and bk and s8_slabs and ms and s8_ms, (
        "the constants moved")
    return (int(n.group(1)), 64 * int(sl.group(1)), int(ms.group(1)),
            64 * int(s8_slabs.group(1)), int(bn.group(1)), int(bk.group(1)),
            int(s8_ms.group(1)))


(SMALL_N, SMALL_ROWS, SMALL_SPLITS, S8_ROWS, S8_N, S8_K,
 S8_SPLITS) = _small_constants()
SERVING = [(3072, 1024), (1024, 1024), (4096, 1024), (1024, 4096)]


def test_small_constants_are_exported():
    """One m64 slab of 64 columns a warpgroup, up to five slabs (320 rows:
    two frames of 144 and their ragged edge); the int8 unit reads 128-byte
    k-steps; the library exports what the plans read."""
    assert (SMALL_N, SMALL_ROWS, SMALL_SPLITS, S8_ROWS, S8_N, S8_K,
            S8_SPLITS) == (64, 320, 8, 320, 64, 128, 8)
    bf = (CSRC / "gemm_bf16.cu").read_text()
    assert ("o[2] = sm90::kSmallBN;" in bf
            and "o[3] = sm90::SmallTile::kRows;" in bf
            and "o[4] = sm90::kSmallMaxSplits;" in bf)
    s8 = (CSRC / "gemm_s8.cu").read_text()
    assert all(f"o[{i}] = gemm_s8::{n};" in s8
               for i, n in enumerate(("kRows", "BN", "BK", "kMaxSplits")))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("N,K", SERVING + [(64, 64), (192, 960)])
def test_small_chunks_cover_k_once(N, K, sms):
    """The small-M path's K chunks are whole k-steps and cover K once; the
    grid (column tiles x chunks) is one wave of the SMs, and one chunk
    fewer would not be."""
    for M in (1, 16, 143, 144, 145, 288, SMALL_ROWS):
        chunk = block.small_chunk(M, N, K, sms, SMALL_N, K_STEP, SMALL_ROWS,
                                    SMALL_SPLITS)
        assert chunk > 0 and chunk % K_STEP == 0
        splits = -(-K // chunk)
        assert (splits - 1) * chunk < K <= splits * chunk
        tiles = N // SMALL_N
        assert splits <= SMALL_SPLITS
        assert splits == 1 or tiles * splits <= sms
        if chunk > K_STEP:  # a shorter chunk would overflow the wave
            steps = -(-K // K_STEP)
            more = -(-steps // (chunk // K_STEP - 1))
            assert more > SMALL_SPLITS or tiles * more > sms


@pytest.mark.parametrize("M", [144, 288])
@pytest.mark.parametrize("N,K,chunk,plan", [
    (3072, 1024, 512, 0), (1024, 1024, 128, 0), (4096, 1024, 512, 0),
    (1024, 4096, 512, 512)])
def test_small_plan_at_the_serving_shapes(M, N, K, chunk, plan):
    """A denoise step's products on an H100 SXM (132 SMs): the small-M
    path would run fc1, fc2 and the out-projection on 128 blocks, every
    weight byte read by one, and qkv's 48 column tiles in two chunks (96
    blocks: three would need a second wave); by the cost model, fitted to
    gemm_sweep --small, only fc2 takes it: its 4,096-deep K walked by the
    tiled path's 16 blocks costs more than the small path's fixed part."""
    got = block.small_chunk(M, N, K, 132, SMALL_N, K_STEP, SMALL_ROWS,
                            SMALL_SPLITS)
    assert got == chunk
    blocks = N // SMALL_N * -(-K // got)
    assert 132 // 2 < blocks <= 132
    assert block.small_plan(M, N, K, 132, SMALL_N, K_STEP, SMALL_ROWS,
                            SMALL_SPLITS, TILE_M) == plan


@pytest.mark.parametrize("M", [321, 576, 720, 1152, 2304, 3456, 11520])
def test_large_m_keeps_the_tiled_path(M):
    """Past 320 rows (prefill, the VAE, training) the 128x128 / 128x256
    tiles stay: the plan gives no chunk."""
    for N, K in SERVING:
        assert block.small_plan(M, N, K, 132, SMALL_N, K_STEP,
                                SMALL_ROWS, SMALL_SPLITS, TILE_M) == 0


INT8 = SERVING[:3] + [(1024, 4096, 512)]


@pytest.mark.parametrize("blocks", [132, 264])
@pytest.mark.parametrize("N,K,group", [(n, k, k) for n, k in SERVING]
                         + [(1024, 4096, 512), (512, 1024, 256)])
def test_s8_chunks_stay_in_their_group(N, K, group, blocks):
    """The int8 K chunks are whole 128-byte k-steps and cover K once; with
    several K groups (fc2's GELU chunks) a chunk never crosses a group, so
    each group's int32 sum is whole before it is folded."""
    for M in (1, 16, 143, 144, 145, 288, 576, 1152):
        chunk = quant.s8_plan(M, N, K, group, blocks, S8_ROWS, S8_N, S8_K,
                              S8_SPLITS)
        assert chunk % S8_K == 0 and 0 < chunk <= K
        splits = -(-K // chunk)
        assert (splits - 1) * chunk < K <= splits * chunk
        assert splits <= S8_SPLITS
        if group < K:
            assert group % chunk == 0
            for z in range(splits):  # [z chunk, (z + 1) chunk) in one group
                assert z * chunk // group == ((z + 1) * chunk - 1) // group


@pytest.mark.parametrize("M", [144, 288])
@pytest.mark.parametrize("N,K,group,chunk", [
    (3072, 1024, 1024, 512), (1024, 1024, 1024, 256),
    (4096, 1024, 1024, 512), (1024, 4096, 512, 512)])
def test_s8_plan_at_the_serving_shapes(M, N, K, group, chunk):
    """The pair's four GEMMs at one and two frames on 132 blocks: every
    row in one unit, the units within one wave; fc1 and fc2 give every
    block but four a unit, fc2 one K group a unit."""
    got = quant.s8_plan(M, N, K, group, 132, S8_ROWS, S8_N, S8_K,
                        S8_SPLITS)
    assert got == chunk
    units = -(-M // S8_ROWS) * (N // S8_N) * -(-K // got)
    assert units <= 132
    cost = quant.s8_cost(M, N, K, group, 132, S8_ROWS, S8_N, S8_K,
                         got // S8_K)[0]
    for c in range(1, K // S8_K + 1):  # the cheapest the model finds
        if ((group == K or (group // S8_K) % c == 0)
                and -(-K // (c * S8_K)) <= S8_SPLITS):
            assert cost <= quant.s8_cost(M, N, K, group, 132, S8_ROWS,
                                         S8_N, S8_K, c)[0]


@pytest.mark.parametrize("M", [144, 288])
def test_pair_workspace_is_the_carve(M):
    """pair.workspace_bytes is csrc/pair_q.cuh's carve (the pair kernel's
    device code, shared by pair_q.cu and pair_q_exact.cu): thirteen
    buffers on 256-byte boundaries, the last the int32 partials of the GEMM
    whose chunks need the most (none when every GEMM is one chunk)."""
    src = (CSRC / "pair_q.cuh").read_text()
    assert "constexpr int kBuffers = 13;" in src
    D, Hd, G = 1024, 4096, 512
    chunks = tuple(quant.s8_plan(M, N, K, G if i == 3 else K, 132, S8_ROWS,
                                 S8_N, S8_K, S8_SPLITS)
                   for i, (N, K) in enumerate(pair.gemm_shapes(D, Hd)))
    part = max(-(-K // c) * M * N * 4
               for (N, K), c in zip(pair.gemm_shapes(D, Hd), chunks)
               if -(-K // c) > 1)
    buffers = [M * D, M * 4, M * 3 * D * 4, M * D * 4, M * D, M * 4,
               M * D * 2, M * D, M * 4, M * Hd * 4, M * Hd,
               M * (Hd // G) * 4]
    assert pair.workspace_bytes(M, D, Hd, G, chunks) == sum(
        -(-b // 256) * 256 for b in buffers + [part])
    # fc2's eight K groups in eight chunks: its partials are the largest
    assert part == 8 * M * D * 4
    assert pair.workspace_bytes(M, D, Hd, G, (D, D, D, Hd)) == sum(
        -(-b // 256) * 256 for b in buffers)


@pytest.mark.parametrize("M", [144, 288])
def test_pair_workspace_f32_seam(M):
    """The fp32 pairs (csrc/pair_q_f32.cu) carve the same buffers with the
    seam xm in fp32, four bytes an element (pair_q.cuh workspace_layout's
    elem): the carve grows by the seam's second half only."""
    src = (CSRC / "pair_q.cuh").read_text()
    assert "m * D * elem" in src and "sizeof(T), sizes" in src
    D, Hd, G = 1024, 4096, 512
    chunks = (D, D, D, Hd)
    bf16 = pair.workspace_bytes(M, D, Hd, G, chunks)
    assert pair.workspace_bytes(M, D, Hd, G, chunks, 2) == bf16
    grow = -(-M * D * 4 // 256) * 256 - -(-M * D * 2 // 256) * 256
    assert pair.workspace_bytes(M, D, Hd, G, chunks, 4) == bf16 + grow


def test_pair_entries_by_dtype():
    """x's dtype picks the pair's entry point: the fp32 forms have their
    own, with gtax_pair_q's arguments, and their own grid query."""
    assert pair._entry(torch.bfloat16) == "gtax_pair_q"
    assert pair._entry(torch.float32) == "gtax_pair_q_f32"
    assert (build.SIGNATURES["gtax_pair_q_f32"]
            == build.SIGNATURES["gtax_pair_q"])
    assert (build.SIGNATURES["gtax_pair_q_f32_blocks"]
            == build.SIGNATURES["gtax_pair_q_blocks"])


# ----------------------------------------- the int8 GEMM's training form

def _train_constants():
    """(tile rows, k-step, requantization group) as csrc/gemm_s8_train.cuh
    defines them, and the source."""
    src = (CSRC / "gemm_s8_train.cuh").read_text()
    found = [re.search(rf"constexpr int {name} = (\d+);", src)
             for name in ("BM", "BK", "kQGroup")]
    assert all(found), "the training form's constants moved"
    return (*(int(m.group(1)) for m in found), src)


# qkv, out, fc1 with one K group; fc2 in eight of 512
INT8_GROUPS = [(n, k, k) for n, k in SERVING[:3]] + [(1024, 4096, 512)]


def test_s8_train_constants_match_the_kernel():
    """The plan's view of the training form is the kernel's: 128-row tiles
    of 256 columns with one K group and 128 with several (the C entry
    derives the tile as s8_train_tile does), 128-byte k-steps, fc1's
    requantization group covered by a cluster of two 256-column tiles,
    and the entry's arguments those build.SIGNATURES binds."""
    rows, k_step, qgroup, src = _train_constants()
    assert (rows, k_step) == (128, quant.S8_TRAIN_K_STEP)
    assert "TBN == 128 || TBN == 256" in src
    assert qgroup == quant.S8_QGROUP
    entry = (CSRC / "gemm_s8_train.cu").read_text()
    assert "const int tile_n = p.n_groups == 1 ? 256 : 128;" in entry
    assert quant.s8_train_tile(4096, 1024, 1024) == 256
    assert quant.s8_train_tile(1024, 4096, 512) == 128
    gelu = (CSRC / "gemm_s8_train_gelu.cu").read_text()
    assert "constexpr int P = kQGroup / 256;" in gelu  # the cluster
    assert gelu.count(", 256, P>(A, B, p, qo, st)") == len(quant.S8_TRAIN_GELU)
    params = re.search(r"GTAX_ENTRY gtax_gemm_s8_train\(([^)]*)\)",
                       entry).group(1)
    assert len(params.split(",")) == len(
        build.SIGNATURES["gtax_gemm_s8_train"])
    assert "gtax_gemm_s8_train" in _entries(("gemm_s8_train.cu",))


@pytest.mark.parametrize("epi", range(8))
def test_s8_train_builds_the_path_s_kernels(epi):
    """The training form builds the kernels #7-#9 launch and no other:
    EPI_F32 with one K group (qkv), the gated epilogues with one or
    several (out, fc2), the GELU epilogues with one and fc1's
    requantization; the C entry refuses the rest as the wrapper does."""
    gelu = epi in (quant.EPI_BIAS_GELU_F32, quant.EPI_BIAS_GELU_ERF_F32,
                   quant.EPI_BIAS_GELU_F32_H, quant.EPI_BIAS_GELU_ERF_F32_H)
    assert (epi in quant.S8_TRAIN_GELU) == gelu
    assert (epi in quant.S8_TRAIN_GATED) == (epi in (2, 4, 7))
    want = {(1, False): not gelu, (8, False): epi in (2, 4, 7),
            (1, True): gelu, (8, True): False}
    got = {k: quant.s8_train_builds(epi, *k) for k in want}
    assert got == want
    entry = (CSRC / "gemm_s8_train.cu").read_text()
    assert "(epi == e::EPI_F32 && p.n_groups != 1)" in entry
    assert "(quant ? (!gelu || p.n_groups != 1" in entry
    assert ": (gelu || C == nullptr" in entry


@pytest.mark.parametrize("M", [144, 288, 576, 1152])
@pytest.mark.parametrize("N,K,group", INT8_GROUPS)
def test_s8_form_keeps_the_streaming_tile_at_serving_rows(M, N, K, group,
                                                          monkeypatch):
    """A denoise step (1-2 frames), the P=4 step and B > 1 serving (4 and 8
    frames) keep the weight-streaming tile for all four products:
    s8_plan_of gives its unit, s8_plan's K chunk (within one K group), the
    K chunks that covers and the int32 partials they store."""
    assert M < quant.S8_TRAIN_ROWS and quant.s8_form(M) == "stream"
    consts = build.GemmConsts(0, 0, 0, 0, 0, S8_ROWS, S8_N, S8_K, S8_SPLITS)
    monkeypatch.setattr(build, "gemm_consts", lambda: consts)
    quant.s8_chunk.cache_clear()
    try:
        plan = quant.s8_plan_of(M, N, K, group, 132)
    finally:
        quant.s8_chunk.cache_clear()
    chunk = quant.s8_plan(M, N, K, group, 132, S8_ROWS, S8_N, S8_K,
                          S8_SPLITS)
    splits = -(-K // chunk)
    assert plan == {"form": "stream", "tile": [S8_ROWS, S8_N],
                    "k_chunk": chunk, "splits": splits,
                    "partials_mb": (splits * M * N * 4 / 1e6
                                    if splits > 1 else 0.0)}
    assert group == K or group % chunk == 0


@pytest.mark.parametrize("M", [11520, 11519])
@pytest.mark.parametrize("N,K,group", INT8_GROUPS)
def test_s8_form_at_training_rows(M, N, K, group):
    """At B=16's 11,520 rows (and a ragged edge) every product takes the
    training form: K whole (one chunk), no int32 partial, a 128-row tile
    of 256 columns with one K group (qkv, out, fc1) and 128 with fc2's
    eight."""
    plan = quant.s8_plan_of(M, N, K, group, 132)
    assert plan["form"] == "train"
    assert (plan["k_chunk"], plan["splits"], plan["partials_mb"]) == (
        K, 1, 0.0)
    tile = plan["tile"][1]
    assert plan["tile"][0] == 128 and N % tile == 0
    assert tile == quant.s8_train_tile(N, K, group)
    assert tile == (256 if group == K else 128)


def test_the_pairs_keep_the_streaming_tile():
    """The paired half-blocks (csrc/pair_q.cuh, one cooperative launch)
    run the weight-streaming tile at every row count: they include
    gemm_s8.cuh alone and plan with s8_chunk, never s8_form."""
    head = (CSRC / "pair_q.cuh").read_text()
    assert '#include "gemm_s8.cuh"' in head and "gemm_s8_train" not in head
    src = Path(pair.__file__).read_text()
    assert "quant.s8_chunk(" in src and "s8_form" not in src


@pytest.mark.parametrize("K,group", [(1024, 1024), (4096, 512), (1024, 256)])
def test_s8_train_folds_whole_groups_in_order(K, group):
    """The kernel's fold (gemm_s8_train.cuh, read from its source): it
    walks K in 128-byte k-steps, folds a group's int32 sums into fp32 at
    the group's last k-step as f + float(acc) * sa[row, g] with g =
    kt / gsteps, the streaming tile's rounding (gemm_s8.cuh), and its
    entry refuses a group that is not whole k-steps. Then, on the CPU, the
    plain version both kernels are held to (s8_fold_plain) against that
    k-step walk, bit for bit: this part checks the plain version's
    arithmetic only; the card test test_gemm_s8_train_bit_equal checks
    the kernel's (fc2: eight groups of 512)."""
    src = (CSRC / "gemm_s8_train.cuh").read_text()
    fold = r"f\[(\w)\] = __fadd_rn\(f\[\1\], __fmul_rn\(__int2float_rn\("
    assert "const int g = kt / gsteps;" in src and re.search(fold, src)
    assert re.search(fold, (CSRC / "gemm_s8.cuh").read_text())
    assert "group % BK" in (CSRC / "gemm_s8_train.cu").read_text()
    step = quant.S8_TRAIN_K_STEP
    assert group % step == 0 and K % group == 0
    gsteps = group // step
    gen = np.random.default_rng(K + group)
    q = torch.from_numpy(gen.integers(-127, 128, (24, K))).to(torch.int8)
    w = torch.from_numpy(gen.integers(-127, 128, (K, 96))).to(torch.int8)
    sa = torch.from_numpy(np.exp(gen.uniform(-6, 6, (24, K // group)))
                          .astype(np.float32))
    ws = torch.from_numpy(gen.uniform(1e-3, 1e-2, 96).astype(np.float32))
    f = torch.zeros((24, 96))
    acc = None
    for kt in range(K // step):  # the kernel's k-steps, in order
        ks = slice(kt * step, (kt + 1) * step)
        part = q[:, ks].long() @ w[ks].long()
        acc = part if kt % gsteps == 0 else acc + part
        if kt % gsteps == gsteps - 1:  # the group's last step: fold
            g = kt // gsteps
            f = f + acc.float() * sa[:, g:g + 1]
    assert torch.equal(f * ws, quant.s8_fold_plain(q, sa, w, ws))
