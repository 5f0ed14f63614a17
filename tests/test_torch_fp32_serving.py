"""float32 on the card: what the serving and training entry points take and
refuse there, through the checks that take the device type (so they run
without a card), and the fp32 forms' dispatch tables. The fp32 kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py);
here the CPU runs fp32 through the plain versions
(tests/test_torch_serving.py holds that rollout against gtax's).
"""

import pytest
import torch

from gtax_torch import serving
from gtax_torch.kernels import block, build
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
    """fp32 + int8 and fp32 + `pallas` raise on the card, naming their
    ROADMAP.md item; the CPU runs both through the plain versions, and
    bf16 takes both on the card."""
    cfg = serving.ServingConfig(**{**KW, field: value})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A10"):
        serving._check_slice(cfg, "cuda")
    serving._check_slice(cfg, "cpu")
    bf16 = serving.ServingConfig(**{**KW, "dtype": "bfloat16", field: value})
    serving._check_slice(bf16, "cuda")


def test_fp32_refusal_reaches_the_generator():
    """VideoGenerator checks with its own device: on the CPU the fp32 int8
    generator builds (its refusal is the card's only)."""
    cfg = serving.ServingConfig(**KW, quantize="int8")
    gen = serving.VideoGenerator.load("", "", cfg, device="cpu")
    assert gen._dtype == torch.float32


@pytest.mark.parametrize("dtype,device_type,refused", [
    (torch.float32, "cuda", True), (torch.bfloat16, "cuda", False),
    (torch.float32, "cpu", False), (torch.bfloat16, "cpu", False)])
def test_fp32_training_refused_on_the_card(dtype, device_type, refused):
    """The trainer's compute dtype: fp32 training on the card is a later
    slice (ROADMAP.md A11)."""
    if refused:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A11"):
            trainer.check_compute_dtype(dtype, device_type)
    else:
        trainer.check_compute_dtype(dtype, device_type)


def test_fp32_entry_points_bound():
    """Every fp32 kernel's C entry point has its ctypes signature, with as
    many arguments as csrc/ declares (the library is built on the card)."""
    want = {"gtax_gemm_f32": 16, "gtax_gemm_f32_rope_qkv": 15,
            "gtax_attn_frame_f32": 9,
            "gtax_attn_temporal_window_f32": 11,
            "gtax_attn_temporal_f32": 13}
    src = "".join(p.read_text() for p in build.sources())
    for name, n in want.items():
        assert len(build.SIGNATURES[name]) == n, name
        assert f"GTAX_ENTRY {name}(" in src, name
    # the pair's exact-GELU flag sits before its stream
    assert len(build.SIGNATURES["gtax_pair_q"]) == 48


def test_fp32_epilogue_table():
    """gemm_f32 takes the epilogues #1-#5 store in fp32 and refuses the
    training ones (fp32 emit_train is a later slice)."""
    assert set(block.F32_EPILOGUES) == {
        block.EPI_F32, block.EPI_BIAS_BF16, block.EPI_BIAS_GELU_TANH,
        block.EPI_BIAS_GELU_ERF, block.EPI_BIAS_BF16_GELU,
        block.EPI_BIAS_GATED, block.EPI_BIAS_BF16_RESID}
    for epi in (block.EPI_BIAS_GATED_Y, block.EPI_BIAS_GELU_TANH_H,
                block.EPI_DGELU):
        with pytest.raises(ValueError, match="no epilogue"):
            block.launch_gemm_f32(None, None, None, 1, 4, 16, epi)


@pytest.mark.parametrize("M,N,K,chunk", [
    (144, 1024, 1024, 128),   # the step's out-projection: 48 blocks x 8
    (144, 1024, 4096, 512),   # the step's fc2
    (144, 3072, 1024, 128),   # qkv: 144 blocks x 8
    (288, 3072, 1024, 128),   # two frames' qkv: 240 blocks x 8
    (576, 3072, 1024, 256),   # the prefill's qkv: 432 blocks x 4
    (576, 4096, 1024, 512),   # the prefill's fc1: 576 blocks x 2
    (720, 3072, 1024, 512),   # five frames: 128x128 tiles at 1.1 waves lose
    (2304, 3072, 1024, 1024),  # the VAE encode: 128x128 tiles, 3.3 waves
    (3456, 4096, 1024, 1024),  # the VAE decode's fc1: 864 wide blocks
    (3456, 1024, 4096, 2048),  # its fc2: 216 wide blocks, 864 64x64 x 2
    (144, 1024, 1040, 208),   # K of 65 steps: five chunks of 13
])
def test_f32_split_plan(M, N, K, chunk):
    """gemm_f32's K chunk on 132 SMs: unsplit on the 128x128 tile where
    its blocks fill the card twice, else the fewest whole-step chunks
    dividing K that give 8 blocks an SM (or the most there are)."""
    got = block.f32_chunk(M, N, K, 132)
    assert got == chunk
    assert K % got == 0 and got % block.F32_K_STEP == 0
    assert K // got <= block.F32_MAX_SPLITS
