"""Split the serving step's kernels on one NVIDIA GPU: the bf16 step's
branches `fused_spatial_branch` (#1), `fused_mlp_branch` (#2) and
`fused_temporal_step` (#4) by launch, and the paired int8 half-block
(`pair_q`, #10 / #11) by phase; with --temporal instead, the temporal
branch by launch: `fused_temporal_branch` (#3) at emit_train (B=16, T=5,
slot 0 padded) and at the prefill's emit_kv (576 rows), and
`fused_temporal_branch_bwd` (#13, B=16, T=5), each with its attention
launch's byte bound (`temporal_splits`); with --f32 instead, the fp32
step's spatial work: #1 fp32 at one frame by launch, with its attention
launch's TFLOP/s and bound, #4 fp32 at one frame by launch, with its
attention launch's byte bound, and the fp32 pairs by phase, on a probe
copy of csrc/pair_q_f32.cu (`f32_splits`); with --int8-train instead,
`fused_mlp_branch_q` (#9) and `fused_spatial_branch_q` (#7) in emit_train
mode at the B=16 training step's 11,520 rows by launch, over bf16 and fp32
x, with each int8 product's TOP/s, its plan (form, K chunks, int32
partial MB) and one torch._int_mm of the same shape
(`int8_train_splits`).

    python -m gtax_torch.tools.split [--temporal | --f32 | --int8-train]
                                     [--out FILE]
    PYTHONPATH=<checkout> python <this file> --temporal   # another tree
    PYTHONPATH=<checkout> python <this file> --f32        # another tree
    PYTHONPATH=<checkout> python <this file> --int8-train # another tree

The launch split records CUDA events around each kernel launch of one
call, and the gap from each launch's end event to the next one's start
event (`launch_split`, also `chip_smoke.py`'s `[split]`); the events
stretch the call, so it is also timed alone, with events around the whole
call only. The phase split
runs the probe copy of csrc/pair_q.cu (`build.pair_probe_library`, built
here at first use), whose kernel stamps %globaltimer from every block at
its start, after each of its nine phases and after each grid barrier; a
phase's time runs from the first block leaving the barrier before it to
the last block finishing its work, a barrier's from that last block to the
last block leaving it (`pair_phases`). In each GEMM phase the probe also
stamps each block's last unit (csrc/gemm_s8.cuh): when it starts, when its
main loop ends, when its partial (or, with one chunk, its output) is
stored, and when the block's slices of the split sum end; the split
prints the slowest block's times. Shapes are
DiT-S/2's at one and two frames (144 and 288 rows), random seeded
weights. The L2 cache is flushed
and the stream held 10 ms before each timed call. The last line of the
output is a JSON object of every row.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import numpy as np
import torch

CYCLES_PER_MS = 1.98e6  # the H100's boost clock (torch.cuda._sleep counts)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
D, H, HD, S = 1024, 16, 64, 144
PHASES = ("ln_mod", "qkv", "attention", "quant", "out-proj", "ln_mod 2",
          "fc1", "quant 2", "fc2")
GEMM_PHASES = (1, 4, 6, 8)  # qkv, out-proj, fc1, fc2 (0-based)
STAMPS = 18 + 4 * len(GEMM_PHASES)  # csrc/pair_q.cuh kStamps
GEMMS = ("gtax_gemm_bf16", "gtax_gemm_wgrad", "gtax_gemm_rope_qkv",
         "gtax_gemm_f32", "gtax_gemm_f32_rope_qkv", "gtax_gemm_f32_wgrad",
         "gtax_gemm_s8", "gtax_gemm_s8_train")
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, H100 SXM


def _cold(flush):
    """Flush the L2 and hold the stream, so the host enqueues the whole
    call before the card reaches it."""
    flush.zero_()
    torch.cuda._sleep(int(10 * CYCLES_PER_MS))


def launch_split(fn, label, gemm_flops, log=print):
    """Each kernel launch of one call of fn, in order: its ms (CUDA events
    recorded on the stream around the launch), its share of the call, the
    gap from the previous launch's end event to its start event, and for
    the GEMMs (in order, gemm_flops) TFLOP/s; then the call's ms timed
    alone (no events between its launches). (A torch.profiler trace lost
    the first launches of the B=16 backward, so the split is timed
    directly.) Returns the list of entries; the last is the call's
    {"call_ms", "split_call_ms", "gaps_ms"}."""
    from gtax_torch.kernels import build

    real = build.launch
    marks = []

    def timed(name, *args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real(name, *args, **kw)
        ev[1].record()
        marks.append((name, ev))

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    fn()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    _cold(flush)
    call = events()
    build.launch = timed
    try:
        call[0].record()
        fn()
        call[1].record()
    finally:
        build.launch = real
    alone = []
    for _ in range(5):  # the call with no events between its launches
        _cold(flush)
        ev = events()
        ev[0].record()
        fn()
        ev[1].record()
        alone.append(ev)
    torch.cuda.synchronize()
    total = call[0].elapsed_time(call[1])
    call_ms = float(np.median([a.elapsed_time(b) for a, b in alone]))
    flops = list(gemm_flops)
    out, gaps = [], []
    log(f"[split] {label}: {len(marks)} launches, {total:.4f} ms for the "
        f"call with events between its launches, {call_ms:.4f} ms alone")
    prev = None
    for name, (e0, e1) in marks:
        ms = e0.elapsed_time(e1)
        gap = None if prev is None else prev.elapsed_time(e0)
        prev = e1
        entry = {"kernel": name, "ms": ms, "share": ms / total, "gap_ms": gap}
        extra = ""
        if name in GEMMS and flops:
            fl = flops.pop(0)
            entry["tflops"] = fl / ms / 1e9
            unit = "OP" if "_s8" in name else "FLOP"  # int8: operations
            extra = (f", {fl / 1e9:.1f} G{unit} at {entry['tflops']:.0f} "
                     f"T{unit}/s")
        if gap is not None:
            gaps.append(gap)
            extra += f"; gap before it {gap:.4f} ms"
        log(f"[split]   {ms:8.4f} ms {100 * ms / total:5.1f}%  {name}{extra}")
        out.append(entry)
    log(f"[split]   gaps between launches: {sum(gaps):.4f} ms in all")
    out.append({"call_ms": call_ms, "split_call_ms": total, "gaps_ms": gaps})
    return out


def _rand(gen, shape, std=1.0, dt=torch.bfloat16):
    a = gen.standard_normal(shape).astype(np.float32) * std
    return torch.from_numpy(a).to("cuda", dt)


def mlp_inputs(N, seed=10):
    """fused_mlp_branch's arguments over N frames of 144 tokens."""
    gen = np.random.default_rng(seed + N)
    x = _rand(gen, (N, S, D))
    mods = _rand(gen, (N, 3 * D), 0.5)
    return (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:],
            _rand(gen, (D, 4 * D), 0.02), _rand(gen, (4 * D,), 0.02),
            _rand(gen, (4 * D, D), 0.02), _rand(gen, (D,), 0.02))


def attention_inputs(kind, N, seed=50, dt=torch.bfloat16):
    """The arguments of fused_spatial_branch ("spatial", N frames) or of
    fused_temporal_step ("temporal", B=N over a 4-frame cache, slot 0
    padded), the step's shapes; activations and weights of type dt."""
    from gtax_torch.core import rope

    gen = np.random.default_rng(seed + N)
    x = _rand(gen, (N, S, D), dt=dt)
    mods = _rand(gen, (N, 3 * D), 0.5, dt)
    w = (_rand(gen, (D, 3 * D), 0.02, dt), _rand(gen, (D, D), 0.02, dt),
         _rand(gen, (D,), 0.02, dt))
    head = (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:], *w)
    if kind == "spatial":
        f = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                             pixel=True).reshape(S, HD).cuda()
        return (*head, f, H)
    n_ctx = 4
    f = rope.temporal_rope_freqs(torch.arange(n_ctx + 1),
                                 rope.lang_freqs(HD)).cuda()
    kc, vc = (_rand(gen, (N * n_ctx * S, D), dt=dt) for _ in range(2))
    return (*head, kc, vc, f, [False] + [True] * n_ctx, H, n_ctx)


def temporal_attention_bound(split, M, emitted=0, log=print):
    """The byte bound of the temporal attention launch in a launch split of
    #3 or #13 over M rows (each input read once, each output written once):
    attn_temporal_window reads q, k, v and writes O, bf16; attn_temporal
    (the full window before the rope epilogue) read the fp32 qkv product
    and wrote O and `emitted` bf16 rows (q, k, v or the K/V cache);
    attn_temporal_bwd reads q, k, v, dO and writes dq, dk, dv and O."""
    name = next(e["kernel"] for e in split[:-1]
                if e["kernel"].startswith("gtax_attn_temporal"))
    row = M * D * 2
    by = {"gtax_attn_temporal_window": 4 * row,
          "gtax_attn_temporal": M * 3 * D * 4 + (1 + emitted) * row,
          "gtax_attn_temporal_bwd": 8 * row}[name]
    ms = 1e3 * by / HBM_BYTES_PER_S
    log(f"[split]   {name} bound {ms:.4f} ms (bytes; {by / 1e6:.1f} MB)")
    return {"kernel": name, "bound_ms": ms, "bytes": by}


def temporal_inputs(B, T, seed=900):
    """fused_temporal_branch's arguments over B windows of T frames of 144
    tokens, without the window mask (x, shift, scale, gate, qkv_w, out_w,
    out_b, rope_freqs), and a cotangent of x's shape."""
    from gtax_torch.core import rope

    gen = np.random.default_rng(seed + 10 * B + T)
    N = B * T
    x = _rand(gen, (N, S, D))
    mods = _rand(gen, (N, 3 * D), 0.5)
    f = rope.temporal_rope_freqs(torch.arange(T), rope.lang_freqs(HD)).cuda()
    return ((x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:],
             _rand(gen, (D, 3 * D), 0.02), _rand(gen, (D, D), 0.02),
             _rand(gen, (D,), 0.02), f), _rand(gen, (N, S, D)))


def temporal_splits(log=print):
    """#3 and #13 by launch at the training step's and the prefill's shapes
    (random seeded weights, DiT-S/2's widths), each with its attention's
    bound. Where the checkout's temporal branch hands back its modulated
    rows (emit_mod), the backward takes them, as the trainer's does."""
    from gtax_torch.kernels import backward, block

    has_mod = "emit_mod" in inspect.signature(
        block.fused_temporal_branch).parameters
    out = {}
    for key, B, T in (("emit_train", 16, 5), ("emit_kv", 1, 4)):
        M = B * T * S
        a, _ = temporal_inputs(B, T)
        valid = [False] + [True] * (T - 1)
        split = launch_split(
            lambda: block.fused_temporal_branch(*a, valid, H, T,
                                                **{key: True}),
            f"fused_temporal_branch {key} B={B} T={T} ({M} rows)",
            [2 * M * D * 3 * D, 2 * M * D * D], log)
        out[key] = {"launch_split": split,
                    "attention": temporal_attention_bound(
                        split, M, 3 if key == "emit_train" else 2, log)}
    B, T = 16, 5
    M = B * T * S
    a, ct = temporal_inputs(B, T, seed=950)
    kw = {"emit_mod": True} if has_mod else {}
    res = block.fused_temporal_branch(*a, None, H, T, emit_train=True, **kw)
    bargs = (*a[:6], a[7], None, *res[1:5], ct, H, T)
    bkw = {"mod": res[5]} if has_mod else {}
    split = launch_split(
        lambda: backward.fused_temporal_branch_bwd(*bargs, **bkw),
        f"fused_temporal_branch_bwd B={B} T={T} ({M} rows, mod "
        f"{'given' if has_mod else 'formed again'})",
        [2 * M * D * D] * 2 + [2 * M * D * 3 * D] * 2, log)
    out["bwd"] = {"launch_split": split,
                  "attention": temporal_attention_bound(split, M, log=log)}
    return out


def pair_args(kind, N, seed=92, dt=torch.bfloat16):
    """(temporal, the checked launch arguments of pair._launch) of one
    paired half-block over N frames: "spatial", or "temporal" (the step of
    B=N elements over a 4-frame cache, slot 0 padded); activations, biases
    and the cache of type dt (fp32: the fp32 pair, #10 / #11 at x.dtype =
    float32)."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import block, quant

    gen = np.random.default_rng(seed + N)
    x = _rand(gen, (N, S, D), dt=dt)
    mods = _rand(gen, (N, 6 * D), 0.5, dt)
    vec = [mods[:, i * D:(i + 1) * D] for i in range(6)]

    def qw(shape):
        return quant.quantize_weight(_rand(gen, shape, 0.02, dt))

    w = (*qw((D, 3 * D)), *qw((D, D)), _rand(gen, (D,), 0.02, dt),
         *qw((D, 4 * D)), _rand(gen, (4 * D,), 0.02, dt), *qw((4 * D, D)),
         _rand(gen, (D,), 0.02, dt))
    G = 4 * D // quant._mlp_chunks(4 * D)
    if kind == "spatial":
        f = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                             pixel=True).reshape(S, HD).cuda()
        return False, (x, *vec, *w, f, None, None, H, 4 * D, G)
    n_ctx = 4
    f = rope.temporal_rope_freqs(torch.arange(n_ctx + 1),
                                 rope.lang_freqs(HD)).cuda()
    kc, vc = (_rand(gen, (N * n_ctx * S, D), dt=dt) for _ in range(2))
    bits = block.valid_bits([False] + [True] * n_ctx, n_ctx + 1)
    return True, (x, *vec, *w, f, kc, vc, H, 4 * D, G, N, 1, n_ctx, bits)


def pair_probe(dt=torch.bfloat16):
    """The probe copy of the pair's bf16 sources (build.pair_probe_library)
    or, for dt fp32, of its fp32 sources, pair_q_f32.cu and
    pair_q_f32_exact.cu, built here with GTAX_PAIR_PROBE (through
    build.build and build._load, which every tree of the port has, so that
    another checkout's fp32 pair is split as well)."""
    from gtax_torch.kernels import build

    if dt != torch.float32:
        return build.pair_probe_library()
    if "pair_f32" not in build._probes:
        build._probes["pair_f32"] = build._load(
            build.build(defines=("GTAX_PAIR_PROBE=1",),
                        names=("pair_q_f32.cu", "pair_q_f32_exact.cu")),
            ("gtax_pair_q_f32", "gtax_pair_q_f32_blocks"))
    return build._probes["pair_f32"]


def pair_phases(kind, N, iters=15, log=print, dt=torch.bfloat16):
    """The probe copy's phase split of one pair call (dt: bf16, or the fp32
    pair): per phase and per grid barrier the median ms over `iters`
    calls, and the whole call's median from the stamps. Returns
    {"phases": {...}, "barriers": [...], "total_ms": ...}."""
    from gtax_torch.kernels import pair

    temporal, args = pair_args(kind, N, dt=dt)
    lib = pair_probe(dt)
    blocks = pair.grid_blocks(temporal, HD, S, D, dt, lib)
    extra = blocks * STAMPS * 8
    ref = pair._launch(temporal, *args)[0]
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    runs = []
    for i in range(iters + 2):
        _cold(flush)
        out, ws = pair._launch(temporal, *args, lib=lib, extra=extra)
        torch.cuda.synchronize()
        if i == 0 and not torch.equal(out, ref):
            raise RuntimeError("the probe copy's output differs from the "
                               "library's")
        if i >= 2:
            t = ws[-extra:].view(torch.int64).view(blocks, STAMPS).cpu()
            runs.append(t.double() / 1e6)  # ns -> ms
    phase = {p: [] for p in PHASES}
    barrier = [[] for _ in PHASES[:-1]]
    # GEMM phases, each block's last unit: from the phase's start to the
    # unit's, its main loop, its partial's hand-off, the tile's sum
    unit = {PHASES[p]: [[] for _ in range(4)] for p in GEMM_PHASES}
    total = []
    for t in runs:
        total.append(float(t[:, 17].max() - t[:, 0].min()))
        for p, name in enumerate(PHASES):
            start, end = t[:, 2 * p], t[:, 2 * p + 1]
            phase[name].append(float(end.max() - start.min()))
            if p < len(PHASES) - 1:
                barrier[p].append(float(t[:, 2 * p + 2].max() - end.max()))
            if p in GEMM_PHASES:
                u = t[:, 18 + 4 * GEMM_PHASES.index(p):][:, :4]
                # blocks with no unit in this phase stamped nothing
                u = u[((u >= start.min()) & (u <= end.max())).all(1)]
                for k, d in enumerate((u[:, 0] - start.min(),
                                       u[:, 1] - u[:, 0], u[:, 2] - u[:, 1],
                                       u[:, 3] - u[:, 2])):
                    unit[name][k].append(float(d.max()))
    res = {"phases": {k: float(np.median(v)) for k, v in phase.items()},
           "barriers": [float(np.median(b)) for b in barrier],
           "gemm_units": {k: [float(np.median(x)) for x in v]
                          for k, v in unit.items()},
           "total_ms": float(np.median(total)), "blocks": blocks}
    label = f"pair_q {kind} N={N}" + (", fp32" if dt == torch.float32 else "")
    log(f"[split] {label}: {blocks} blocks, {res['total_ms']:.4f} ms from "
        f"the first block's start to the last block's end (probe copy)")
    for p, name in enumerate(PHASES):
        ms = res["phases"][name]
        bar = (f"; barrier after it {res['barriers'][p]:.4f} ms"
               if p < len(PHASES) - 1 else "")
        log(f"[split]   {ms:8.4f} ms {100 * ms / res['total_ms']:5.1f}%  "
            f"phase {p + 1} {name}{bar}")
        if name in res["gemm_units"]:
            a, b, c, d = res["gemm_units"][name]
            log(f"[split]            its units (the slowest block's last): "
                f"start {a:.4f}, main loop {b:.4f}, partial out {c:.4f}, "
                f"barrier and the split sum's slices {d:.4f} ms")
    return res


def int8_train_args(kind, dt, seed=960):
    """#7 ("spatial") or #9 ("mlp") at the B=16 training step's 80 frames
    of 144 tokens (11,520 rows): its arguments, the int8 weights quantized
    on the card by the checkout's own quant.quantize_weight, activations,
    adaLN rows and biases of type dt."""
    from gtax_torch.core import rope
    from gtax_torch.kernels import quant

    gen = np.random.default_rng(seed + (kind == "mlp"))
    N = 80
    x = _rand(gen, (N, S, D), dt=dt)
    mods = _rand(gen, (N, 3 * D), 0.5, dt)
    head = (x, mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:])

    def qw(shape):
        return quant.quantize_weight(_rand(gen, shape, 0.02, dt))

    if kind == "mlp":
        return (*head, *qw((D, 4 * D)), _rand(gen, (4 * D,), 0.02, dt),
                *qw((4 * D, D)), _rand(gen, (D,), 0.02, dt))
    f = rope.axial_freqs(rope.pixel_freqs(HD // 2, 256.0), (9, 16),
                         pixel=True).reshape(S, HD).cuda()
    return (*head, *qw((D, 3 * D)), *qw((D, D)), _rand(gen, (D,), 0.02, dt),
            f, H)


# (product, N, K, K group) of #7's and #9's int8 GEMMs
INT8_PRODUCTS = {"spatial": (("qkv", 3 * D, D, D), ("out", D, D, D)),
                 "mlp": (("fc1", 4 * D, D, D), ("fc2", D, 4 * D, 512))}


def s8_plan_log(M, what, N, K, group, log=print):
    """The checkout's plan of one int8 product at M rows
    (quant.s8_plan_of where it has one: the form, its tile, K chunks and
    int32 partial MB; else the streaming tile's quant.s8_chunk), logged."""
    from gtax_torch.kernels import block, quant

    sms = block.sm_count(torch.device("cuda"))
    if hasattr(quant, "s8_plan_of"):
        plan = quant.s8_plan_of(M, N, K, group, sms)
    else:
        chunk = quant.s8_chunk(M, N, K, group, sms)
        splits = -(-K // chunk)
        plan = {"form": "stream", "k_chunk": chunk, "splits": splits,
                "partials_mb": (splits * M * N * 4 / 1e6 if splits > 1
                                else 0.0)}
    log(f"[split]   {what} plan at M={M}: {json.dumps(plan)}")
    return plan


def int_mm_row(M, what, N, K, log=print, seed=970):
    """One torch._int_mm of an (M, K) @ (K, N) int8 product on a
    column-major weight (as gemm_sweep.py feeds it): its ms and TOP/s,
    logged."""
    gen = np.random.default_rng(seed + N + K)
    q = torch.from_numpy(gen.integers(-127, 128, (M, K), dtype=np.int8))
    w = torch.from_numpy(gen.integers(-127, 128, (K, N), dtype=np.int8))
    from gtax_torch.tools.gemm_sweep import median_ms

    q, w = q.cuda(), w.cuda().t().contiguous().t()
    ms = median_ms(lambda: torch._int_mm(q, w))
    tops = 2 * M * N * K / ms / 1e9
    log(f"[split]   {what} torch._int_mm M={M} N={N} K={K}: {ms:.4f} ms, "
        f"{tops:.0f} TOP/s ({100 * tops * 1e12 / INT8_OPS_PER_S:.1f}% of "
        f"1,979)")
    return {"ms": ms, "tops": tops}


def int8_train_splits(log=print):
    """#9 fused_mlp_branch_q and #7 fused_spatial_branch_q in emit_train
    mode at B=16 (11,520 rows) by launch, over bf16 and fp32 x, each int8
    product's TOP/s; each product's plan (form, K chunks, int32 partial
    MB); torch._int_mm of each product on the same shapes."""
    from gtax_torch.kernels import quant

    M = 80 * S
    out = {}
    for kind, fn in (("mlp", quant.fused_mlp_branch_q),
                     ("spatial", quant.fused_spatial_branch_q)):
        prods = INT8_PRODUCTS[kind]
        for dt in (torch.bfloat16, torch.float32):
            a = int8_train_args(kind, dt)
            label = (f"{fn.__name__} emit_train B=16 ({M} rows)"
                     + (", fp32" if dt == torch.float32 else ""))
            out[label] = launch_split(
                lambda: fn(*a, emit_train=True), label,
                [2 * M * N * K for _, N, K, _ in prods], log)
            del a
        out[f"{kind} plans"] = {what: s8_plan_log(M, what, N, K, g, log)
                                for what, N, K, g in prods}
        out[f"{kind} int_mm"] = {what: int_mm_row(M, what, N, K, log)
                                 for what, N, K, _ in prods}
    return out


F32_PEAK = 67e12  # fp32 FFMA, H100 SXM


def temporal_step_f32_bound(split, n_ctx=4, log=print):
    """The attention launch in a launch split of #4 fp32 at one frame (144
    rows over an n_ctx-frame fp32 cache; gtax_attn_step_f32, or an older
    tree's gtax_attn_temporal_f32): its ms and byte bound (the live
    frame's qkv rows and the cache's K and V read, the output written,
    fp32, at 3.35 TB/s; its 4 T d FLOPs a query row and head are far
    below), printed."""
    name, ms = next((e["kernel"], e["ms"]) for e in split[:-1]
                    if e["kernel"].startswith("gtax_attn_"))
    by = (S * 3 * D + 2 * n_ctx * S * D + S * D) * 4
    bound = 1e3 * by / HBM_BYTES_PER_S
    log(f"[split]   {name} {ms:.4f} ms; bound {bound:.4f} ms "
        f"(bytes; {by / 1e6:.2f} MB)")
    return {"kernel": name, "ms": ms, "bound_ms": bound, "bytes": by}


def f32_splits(log=print):
    """The fp32 step's work: #1 fp32 at one frame (144 rows) by launch,
    with its attention launch's (gtax_attn_frame_f32: the rope pass and
    the attention) TFLOP/s and bound (the larger of 4 S^2 d a head at 67
    TFLOP/s and its bytes, the qkv rows read and the output written, at
    3.35 TB/s); #4 fp32 at one frame over a 4-frame cache by launch, with
    its products' TFLOP/s and its attention launch's byte bound
    (temporal_step_f32_bound); the fp32 pairs by phase (#10 at one and
    two frames, #11 at one)."""
    from gtax_torch.kernels import block

    f32 = torch.float32
    a = attention_inputs("spatial", 1, dt=f32)
    gemms = [2 * S * D * 3 * D, 2 * S * D * D]
    split = launch_split(lambda: block.fused_spatial_branch(*a),
                         f"fused_spatial_branch {S} rows, fp32", gemms, log)
    ms = next(e["ms"] for e in split[:-1]
              if e["kernel"] == "gtax_attn_frame_f32")
    flops = 4 * H * S * S * HD
    bound = max(flops / F32_PEAK, (S * 3 * D + S * D) * 4 / HBM_BYTES_PER_S)
    attention = {"ms": ms, "tflops": flops / ms / 1e9,
                 "bound_ms": bound * 1e3}
    log(f"[split]   gtax_attn_frame_f32 (rope pass + attention) {ms:.4f} ms,"
        f" {flops / 1e9:.3f} GFLOP at {attention['tflops']:.1f} TFLOP/s; "
        f"bound {attention['bound_ms']:.4f} ms")
    t = attention_inputs("temporal", 1, dt=f32)
    step = launch_split(lambda: block.fused_temporal_step(*t),
                        f"fused_temporal_step {S} rows, fp32", gemms, log)
    pairs = {f"{kind} N={N}": pair_phases(kind, N, log=log, dt=f32)
             for kind, N in (("spatial", 1), ("spatial", 2),
                             ("temporal", 1))}
    return {"spatial": {"launch_split": split, "attention": attention},
            "temporal_step": {"launch_split": step,
                              "attention": temporal_step_f32_bound(step,
                                                                   log=log)},
            "pair": pairs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--temporal", action="store_true",
                      help="split #3 and #13 instead (temporal_splits)")
    mode.add_argument("--f32", action="store_true",
                      help="split the fp32 step's #1 and pairs instead "
                      "(f32_splits)")
    mode.add_argument("--int8-train", action="store_true",
                      help="split #9 and #7 emit_train at B=16 instead "
                      "(int8_train_splits)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split: needs a CUDA device")
    from gtax_torch.kernels import block
    from gtax_torch.utils.platform import strict_matmul

    strict_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.temporal or args.f32 or args.int8_train:
        run = (temporal_splits if args.temporal else f32_splits if args.f32
               else int8_train_splits)
        with torch.inference_mode():
            result = {"card": card, **run()}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f)
        print(json.dumps(result))
        return
    result = {"card": card, "mlp": {}, "spatial": {}, "temporal": {},
              "pair": {}}
    with torch.inference_mode():
        for kind, fn in (("spatial", block.fused_spatial_branch),
                         ("temporal", block.fused_temporal_step)):
            for N in (1, 2):
                a = attention_inputs(kind, N)
                M = N * S
                result[kind][M] = launch_split(
                    lambda: fn(*a), f"{fn.__name__} {M} rows",
                    [2 * M * D * 3 * D, 2 * M * D * D])
        for N in (1, 2):
            a = mlp_inputs(N)
            M = N * S
            result["mlp"][M] = launch_split(
                lambda: block.fused_mlp_branch(*a),
                f"fused_mlp_branch {M} rows", [2 * M * D * 4 * D] * 2)
        for kind in ("spatial", "temporal"):
            for N in (1, 2):
                result["pair"][f"{kind} N={N}"] = pair_phases(kind, N)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
