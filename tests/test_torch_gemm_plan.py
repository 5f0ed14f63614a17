"""The launch arithmetic of the port's bf16 GEMMs, and the kernel
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

import pytest

from gtax_torch.kernels import backward, build

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
