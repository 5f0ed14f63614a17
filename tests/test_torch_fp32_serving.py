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
    the fp32 GEMM's with the training epilogues' outputs and trans_b, the
    frame attention's with its q/k/v stores, the temporal one's with the
    full window's fp32 Q/K/V outputs, the fp32 pairs', the fp32 `pallas`
    attention's, and the fp32 training kernels' (the weight gradient, the
    row-wise and attention backwards)."""
    want = {"gtax_gemm_f32": 22, "gtax_gemm_f32_rope_qkv": 15,
            "gtax_attn_frame_f32": 12,
            "gtax_attn_temporal_window_f32": 11,
            "gtax_attn_temporal_f32": 16, "gtax_pair_q_f32": 48,
            "gtax_pair_q_f32_blocks": 4, "gtax_attn_sdpa_f32": 16,
            "gtax_gemm_f32_wgrad": 8, "gtax_gate_bwd_f32": 11,
            "gtax_ln_mod_bwd_f32": 12, "gtax_attn_frame_bwd_f32": 15,
            "gtax_attn_temporal_bwd_f32": 14}
    src = "".join(p.read_text() for p in build.sources())
    for name, n in want.items():
        assert len(build.SIGNATURES[name]) == n, name
        assert f"GTAX_ENTRY {name}(" in src, name
    # the pair's exact-GELU flag sits before its stream
    assert len(build.SIGNATURES["gtax_pair_q"]) == 48
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
    (144, 1024, 1024, 128),   # the step's out-projection: 48 blocks x 8
    (144, 1024, 4096, 512),   # the step's fc2
    (144, 3072, 1024, 128),   # qkv: 144 blocks x 8
    (288, 3072, 1024, 128),   # two frames' qkv: 240 blocks x 8
    (576, 3072, 1024, 256),   # the prefill's qkv: 432 blocks x 4
    (576, 4096, 1024, 512),   # the prefill's fc1: 576 blocks x 2
    (720, 3072, 1024, 352),   # five frames: 144 tiles, 3 chunks of 11 steps
    (2304, 3072, 1024, 1024),  # the VAE encode's qkv: 432 tiles, K of 32
    (3456, 4096, 1024, 1024),  # the VAE decode's fc1: 864 tiles
    (3456, 1024, 4096, 704),   # its fc2: 216 tiles of 128 steps, 6 chunks
    (144, 1024, 1040, 208),   # K of 65 steps: five chunks of 13
])
def test_f32_split_plan(M, N, K, chunk):
    """gemm_f32's K chunk on 132 SMs. Below 720 rows: the fewest
    whole-step chunks dividing K that give 8 of the 64x64 tile's blocks an
    SM (or the most there are). From 720 rows (the forward's k-major
    form, two blocks an SM): unsplit where K is at most 32 steps of 32 and
    the tiles fill the 264 slots, else the count of at most 8 chunks of
    whole 32-row steps (the last one short) with the fewest wave-steps."""
    got = block.f32_chunk(M, N, K, 132)
    assert got == chunk
    if M >= block.F32_FWD_ROWS:
        assert got == K or got % block.F32_FWD_K_STEP == 0
        assert -(-K // got) <= block.F32_MAX_SPLITS
    else:
        assert K % got == 0 and got % block.F32_K_STEP == 0
        assert K // got <= block.F32_MAX_SPLITS


def test_f32_fwd_constants_match_the_kernel_source():
    """block's constants of gemm_f32's forward from 720 rows are the
    kernel's (csrc/gemm_f32.cu FwdShape, kFwdRows): the tile's rows
    (kBwdTile) and columns, its 32-row step and its blocks an SM."""
    import re

    src = (build.CSRC / "gemm_f32.cu").read_text()
    shape = re.search(r"struct FwdShape \{\s*static constexpr int TW = (\d+), "
                      r"KS = (\d+), STAGES = \d+, BLOCKS = (\d+);", src)
    assert int(shape.group(1)) == block.F32_FWD_TILE
    assert int(shape.group(2)) == block.F32_FWD_K_STEP
    assert int(shape.group(3)) == block.F32_FWD_BLOCKS
    assert int(re.search(r"constexpr int kBwdTile = (\d+);", src).group(1)) \
        == block.F32_FWD_TILE
    assert int(re.search(r"constexpr int kFwdRows = (\d+);", src).group(1)) \
        == block.F32_FWD_ROWS
    assert block.F32_FWD_K_STEP % block.F32_K_STEP == 0


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
