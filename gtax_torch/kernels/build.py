"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are `gtax_torch/csrc/*.cu` (plus the shared `*.cuh` headers).
Each `.cu` file has a plain C interface, so no PyTorch header is compiled:
every source goes to its own `nvcc -c` process, all started together, and
one `nvcc -shared` links the objects into `libgtax_kernels.so`. The library
lands in `gtax_torch/_build/<hash>/`, keyed by a hash of the sources and the
flags, so an unchanged checkout builds once and a changed source rebuilds.
The build runs at first use, inside the first wrapper call that launches a
kernel (or `library()` called directly); a missing nvcc or a failed build
raises. With an AOT cache in use (`use_cache`, gtax_torch.aot: serving's
`aot_dir`), `library()` takes the library from the cache instead: a
loaded artifact needs no nvcc. `probe_library` builds the two attention
sources alone with GTAX_PROBE_STOP defined, a copy whose kernels stop
early so that gtax_torch/tools/attn_sweep.py can time their phases;
`pair_probe_library` builds pair_q.cu (and pair_q_exact.cu, which it
links to) alone with GTAX_PAIR_PROBE defined,
a copy that stamps the clock at each of its phases for
gtax_torch/tools/split.py. Nothing else loads either.

C entry points take pointers and the stream as `c_void_p` and sizes as
`c_int`, and return `cudaGetLastError()`; `launch` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libgtax_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry point -> argument types (see the GTAX_ENTRY functions in csrc/)
SIGNATURES = {
    # x, out, row_scale, p0, p1, rows, D, S, p_stride, mode, stream
    "gtax_ln_mod": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # A, B, C, C2, aux, colsum, bias, bias_f32, resid, gate, gate_stride, M,
    # N, K, S, epi, trans_b, k_chunk, part, stream
    "gtax_gemm_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P, _P),
    # out: int[5] = the GEMM tile's rows, k-step, the small-M path's
    # columns, rows, most K chunks
    "gtax_gemm_consts": (_P,),
    # out: int[4] = the int8 unit's rows, columns, k-step, most K chunks
    "gtax_gemm_s8_consts": (_P,),
    # A, B, q, k, v, freqs, M, D, S, n_q, q_off, hd, k_chunk, part, stream
    "gtax_gemm_rope_qkv": (*(_P,) * 6, *(_I,) * 7, _P, _P),
    # gtax_gemm_bf16's arguments, over fp32 operands, with lda, ldc, the
    # forward's form, the persistent form's blocks and counters after
    # k_chunk
    "gtax_gemm_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # A, B, C, M, Ka, N, chunk, stream (gtax_gemm_wgrad's, over fp32)
    "gtax_gemm_f32_wgrad": (_P, _P, _P, _I, _I, _I, _I, _P),
    # A, B, q, k, v, freqs, M, D, S, n_q, q_off, hd, k_chunk, fwd, part,
    # stream
    "gtax_gemm_f32_rope_qkv": (*(_P,) * 6, *(_I,) * 8, _P, _P),
    # A, B, C, M, Ka, N, chunk, stream
    "gtax_gemm_wgrad": (_P, _P, _P, _I, _I, _I, _I, _P),
    # N -> the weight-gradient tile's columns, or -error
    "gtax_gemm_wgrad_tile_n": (_I,),
    # in, out, R, C, stream
    "gtax_reduce_rows": (_P, _P, _I, _L, _P),
    # ct, y, gate, gate_stride, dy, dg, dysum, F, S, D, stream
    "gtax_gate_bwd": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    "gtax_gate_bwd_f32": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    # x, dmod, scale, p_stride, ct, dx, dshift, dscale, F, S, D, stream
    "gtax_ln_mod_bwd": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "gtax_ln_mod_bwd_f32": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    # A, B, C, C2, sa, group, ws, bias, bias_f32, resid, gate, gate_stride,
    # M, N, K, S, epi, k_chunk, part, stream
    "gtax_gemm_s8": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                     _I, _I, _I, _I, _P, _P),
    # gtax_gemm_s8's arguments without k_chunk and part, then hq, hs,
    # stream
    "gtax_gemm_s8_train": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                           _I, _I, _I, _I, _I, _P, _P, _P),
    # a, q, scale, rows, cols, G, stream
    "gtax_quant_rows": (_P, _P, _P, _I, _I, _I, _P),
    # qkv, qkv_f32, freqs, out, out_f32, q_out, k_out, v_out, n_frames, S,
    # D, num_heads, rot, stream
    "gtax_attn_frame": (_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P),
    # qkv, freqs, k_ctx, v_ctx, out, out_f32, q_out, k_out, v_out, B, n_q,
    # q_off, S, D, num_heads, valid_mask, stream
    "gtax_attn_temporal": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _P),
    # q, k, v, out, B, T, S, D, num_heads, valid_mask, stream
    "gtax_attn_temporal_window": (*(_P,) * 4, *(_I,) * 6, _P),
    "gtax_attn_temporal_window_f32": (*(_P,) * 4, *(_I,) * 6, _P),
    # qkv, freqs, k_ctx, v_ctx, out, q_out, k_out, v_out, B, n_q, q_off, S,
    # D, num_heads, valid_mask, stream
    "gtax_attn_temporal_f32": (*(_P,) * 8, *(_I,) * 7, _P),
    # qkv, freqs, k_ctx, v_ctx, out, B, n_q, q_off, S, D, num_heads,
    # valid_mask, stream
    "gtax_attn_step_f32": (*(_P,) * 5, *(_I,) * 7, _P),
    # qkv, freqs, out, q_out, k_out, v_out, ws, n_frames, S, D, num_heads,
    # rot, shape, stream
    "gtax_attn_frame_f32": (*(_P,) * 7, *(_I,) * 6, _P),
    # q, k, v, dout, cos, sin, dqkv, ao, n_frames, S, D, num_heads, rot,
    # stream
    "gtax_attn_frame_bwd": (*(_P,) * 8, *(_I,) * 5, _P),
    # the same over fp32, with stats (the passes' row statistics) after ao
    "gtax_attn_frame_bwd_f32": (*(_P,) * 9, *(_I,) * 5, _P),
    # q, k, v, dout, freqs, dqkv, ao, B, T, S, D, num_heads, valid_mask,
    # stream
    "gtax_attn_temporal_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _P),
    "gtax_attn_temporal_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _P),
    # temporal, x, sh1, sc1, g1, sh2, sc2, g2, p1_stride, g1_stride,
    # p2_stride, g2_stride, qkv_q, qkv_s, out_q, out_s, out_b, out_b_f32,
    # w1_q, w1_s, b1, b1_f32, w2_q, w2_s, b2, b2_f32, freqs, k_ctx, v_ctx,
    # out, ws, ws_bytes, M, S, D, Hd, G, num_heads, B, n_live, n_ctx,
    # valid_mask, kc_qkv, kc_out, kc_fc1, kc_fc2, exact_gelu, attn_shape,
    # stream
    "gtax_pair_q": (_I, *(_P,) * 7, *(_I,) * 4, *(_P,) * 5, _I,
                    *(_P,) * 3, _I, *(_P,) * 3, _I, *(_P,) * 5, _L,
                    *(_I,) * 16, _P),
    # temporal, hd, S, D -> the cooperative grid's blocks, or -error
    "gtax_pair_q_blocks": (_I, _I, _I, _I),
    # gtax_pair_q's arguments, over fp32 activations
    "gtax_pair_q_f32": (_I, *(_P,) * 7, *(_I,) * 4, *(_P,) * 5, _I,
                        *(_P,) * 3, _I, *(_P,) * 3, _I, *(_P,) * 5, _L,
                        *(_I,) * 16, _P),
    "gtax_pair_q_f32_blocks": (_I, _I, _I, _I),
    # q, k, v, bias, out, N, S, num_heads, hd, q_ld, k_ld, v_ld, o_ld,
    # tensor_cores, scale, stream
    "gtax_attn_sdpa": (*(_P,) * 5, *(_I,) * 9, _F, _P),
    # the same over fp32 q, k, v, out; tiled in place of tensor_cores
    "gtax_attn_sdpa_f32": (*(_P,) * 5, *(_I,) * 9, _F, _P),
}
# the sources of the probe copy, and the entry points it binds
PROBE_SOURCES = ("attn_sdpa.cu", "attn_bwd.cu")
PROBE_ENTRIES = ("gtax_attn_sdpa", "gtax_attn_frame_bwd")
PAIR_PROBE_SOURCES = ("pair_q.cu", "pair_q_exact.cu")
PAIR_PROBE_ENTRIES = ("gtax_pair_q", "gtax_pair_q_blocks")

_lib = None
_cache = None  # the AOT cache library() takes its library from (use_cache)
_lib_lock = threading.Lock()  # a prewarm thread and a caller may race
_probes = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(flags, names=None) -> str:
    h = hashlib.sha256(" ".join((*flags, *(names or ()))).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def source_digest() -> str:
    """The hash of the library's sources and flags (its build directory's
    name)."""
    return _digest(NVCC_FLAGS)


def find_nvcc() -> str | None:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc (CUDA_HOME defaults to
    /usr/local/cuda), else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    return default if os.path.exists(default) else None


def _nvcc() -> str:
    found = find_nvcc()
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels cannot be built")
    return found


def build(verbose: bool = False, defines=(), names=None,
          out: Path | None = None) -> Path:
    """Compile csrc/*.cu (or the sources `names`) into the shared library,
    with the macros `defines` ("NAME=value"), unless the current sources
    were built so already; returns the library path. out: write the
    library there instead, always building (the AOT cache's build)."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    srcs = sources() if names is None else [CSRC / n for n in names]
    if out is None:
        out = BUILD_DIR / _digest(flags, names) / LIB_NAME
        if out.exists():
            return out
        work = BUILD_DIR
    else:
        work = Path(out).parent
    nvcc = _nvcc()
    work.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=work))
    try:
        extra = ("-Xptxas", "-v") if verbose else ()
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *flags, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}")
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *flags, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, out)  # atomic: concurrent builders race safely
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _load(path: Path, names):
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def load_library(path):
    """The kernel library at `path`, its entry points bound (a missing one
    raises AttributeError; a file that is not a library, OSError)."""
    return _load(Path(path), SIGNATURES)


def library():
    """The loaded kernel library: from the AOT cache in use, else built at
    first use. Every launch calls it: the lock is taken only to load."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lib_lock:
        if _lib is None:
            _lib = (_cache.load_or_compile() if _cache is not None
                    else load_library(build()))
        return _lib


def use_cache(cache) -> None:
    """Take the library from `cache` (a gtax_torch.aot.AotCache; None: the
    build directory again) from the next launch on: the library loaded so
    far is dropped (both are builds of the same sources)."""
    global _lib, _cache
    with _lib_lock:
        _cache, _lib = cache, None


def probe_library(stop: int):
    """The probe copy of attn_sdpa and attn_frame_bwd (built at first use,
    with GTAX_PROBE_STOP=stop): their kernels stop after staging (0), or
    after attn_sdpa's first pass over the keys and attn_frame_bwd's phase A
    (1). Their outputs are not the attention's."""
    if stop not in _probes:
        _probes[stop] = _load(build(defines=(f"GTAX_PROBE_STOP={stop}",),
                                    names=PROBE_SOURCES), PROBE_ENTRIES)
    return _probes[stop]


def pair_probe_library():
    """The probe copy of pair_q (built at first use, with GTAX_PAIR_PROBE):
    its kernel computes the pair and also stamps the clock at each phase
    into the workspace past its buffers (csrc/pair_q.cu)."""
    if "pair" not in _probes:
        _probes["pair"] = _load(build(defines=("GTAX_PAIR_PROBE=1",),
                                      names=PAIR_PROBE_SOURCES),
                                PAIR_PROBE_ENTRIES)
    return _probes["pair"]


class GemmConsts(NamedTuple):
    """The GEMMs' tiling as the kernels define it (csrc/gemm_sm90.cuh,
    csrc/gemm_bf16.cu, csrc/gemm_s8.cuh)."""
    tile_m: int  # rows of an output tile (and of a gelu' column partial)
    k_step: int  # depth of a k-step (a wgrad row chunk is a multiple of it)
    small_n: int  # columns of a small-M block
    small_rows: int  # the most rows the small-M path takes
    small_splits: int  # the most K chunks of the small-M path
    s8_rows: int  # rows of an int8 unit (the most one unit covers)
    s8_n: int  # columns of an int8 unit
    s8_k_step: int  # depth of an int8 k-step (a K chunk is a multiple)
    s8_splits: int  # the most K chunks of an int8 GEMM


_consts = None


def gemm_consts() -> GemmConsts:
    """The constants the kernel library exports (built at first use)."""
    global _consts
    if _consts is None:
        bf, s8 = (ctypes.c_int * 5)(), (ctypes.c_int * 4)()
        launch("gtax_gemm_consts", ctypes.addressof(bf))
        launch("gtax_gemm_s8_consts", ctypes.addressof(s8))
        _consts = GemmConsts(*bf, *s8)
    return _consts


def launch(name: str, *args, lib=None) -> None:
    """Call one C entry point (of `lib`, else the library); raise if it
    reports a CUDA error."""
    rc = getattr(lib or library(), name)(*args)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
