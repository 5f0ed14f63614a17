"""The attention kernels of the `pallas` backend: multi-head attention with
an additive (S, S) bias over heads-first or token-major tensors
(counterpart of gtax/kernels/attention.py).

    fused_sdpa(q, k, v, mask, causal)                 q/k/v (..., S, d)
    fused_mha_token_major(q, k, v, num_heads, ...)    q/k/v (..., S, h*d)

Both compute, per head, gtax's `_attn_kernel`: fp32 scores q.k times
d^-1/2 plus the bias of `build_bias` (0 where a query may attend a key,
-1e30 where not), a max-subtracted fp32 softmax as e / sum(e), the
probabilities cast to the input dtype, PV summed in fp32, the output in
the input dtype. Both return None when the mask carries batch dimensions
(or is 2-D but not (S, S)), as gtax's do: callers then take the plain
attention path. That is gtax's dispatch by the mask's shape, decided
before any kernel runs.

The tensor's device picks the path: a CPU tensor gets the plain version
(`sdpa_plain`, `mha_token_major_plain`, any float dtype), a CUDA tensor gets
the sm_90a kernel of gtax_torch/csrc/attn_sdpa.cu (bf16, or its fp32 form)
or an exception: its tensor-core body for rows of SDPA_TENSOR_CORES_MIN_S
tokens or more, its warp-per-row body for shorter ones
(`sdpa_tensor_cores`). In fp32 (gtax's kernels at q.dtype = float32, where
the probabilities' cast is a no-op) the same rule picks between the fp32
form's tiled SIMT body and its warp rows, both on the CUDA cores, nothing
rounded below fp32; the tiled body's tiles by S (`sdpa_f32_body`). Each
wrapper counts its kernel launches in `launches`.
"""

from __future__ import annotations

import functools

import torch

from gtax_torch.kernels import build
from gtax_torch.kernels.block import (_desc, _need, _ptr, _stream,
                                      forward_only)

NEG_BIAS = -1e30


def _mask_tensor(mask):
    return mask if isinstance(mask, torch.Tensor) else torch.as_tensor(
        mask, dtype=torch.bool)


def _bias(S: int, mask, causal: bool, device) -> torch.Tensor:
    allow = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        allow = torch.tril(allow)
    if mask is not None:
        m = mask.to(device=device, dtype=torch.bool)
        allow = allow & (m[None, :].expand(S, S) if m.dim() == 1 else m)
    return torch.where(allow, 0.0, NEG_BIAS).float()


@functools.lru_cache(maxsize=64)
def _cached_bias(S, flags, shape, causal, device):
    mask = None if flags is None else torch.tensor(flags).reshape(shape)
    return _bias(S, mask, causal, "cpu").to(device)


def build_bias(S: int, mask=None, causal: bool = False,
               device="cpu") -> torch.Tensor:
    """Additive (S, S) fp32 bias from the causal flag and an optional (S,)
    key-validity or (S, S) mask, True = attend (gtax/kernels/attention.py
    _build_bias): 0 where allowed, -1e30 where not. A 1-D mask applies to
    every query row. A mask given on the host is turned into a bias on the
    device once and kept, so the step does not copy it every call."""
    if mask is not None:
        mask = _mask_tensor(mask)
        if mask.device.type != "cpu":
            return _bias(S, mask, causal, mask.device)
        return _cached_bias(S, tuple(mask.flatten().tolist()),
                            tuple(mask.shape), causal, torch.device(device))
    return _cached_bias(S, None, None, causal, torch.device(device))


def _unsupported(mask, S) -> bool:
    """gtax's rule: a mask with batch dimensions, or a 2-D one that is not
    (S, S), is not the kernel's (None is returned)."""
    if mask is None:
        return False
    shape = tuple(_mask_tensor(mask).shape)
    return len(shape) > 2 or (len(shape) == 2 and shape != (S, S))


def _attend(q, k, v, bias):
    """The per-head attention of gtax's _attn_kernel on (N, H, S, d)
    operands, fp32 scores and softmax, probabilities in the input dtype."""
    d = q.shape[-1]
    s = (torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float())
         * (1.0 / d**0.5) + bias)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", p.float(), v.float()).to(q.dtype)


def sdpa_plain(q, k, v, bias):
    """Plain version of fused_sdpa: q/k/v (N, S, d), bias (S, S)."""
    return _attend(q[:, None], k[:, None], v[:, None], bias)[:, 0]


def mha_token_major_plain(q, k, v, bias, num_heads):
    """Plain version of fused_mha_token_major: q/k/v (N, S, h*d), head h in
    columns [h*d, (h+1)*d)."""
    N, S, HD = q.shape
    d = HD // num_heads

    def heads(t):
        return t.reshape(N, S, num_heads, d).transpose(1, 2)

    out = _attend(heads(q), heads(k), heads(v), bias)
    return out.transpose(1, 2).reshape(N, S, HD)


# attn_sdpa runs rows of at least this many tokens on its tensor-core body
# (16 query rows a warp, mma.sync), shorter ones on its warp-per-row body;
# PERF.md has the sweep of S in both layouts that set it
SDPA_TENSOR_CORES_MIN_S = 32


def sdpa_tensor_cores(S: int) -> bool:
    """Which of attn_sdpa's two bodies takes rows of S tokens: the
    tensor-core one from SDPA_TENSOR_CORES_MIN_S up. The rule of the
    kernel's dispatch, decided by S alone and passed to the C entry."""
    return S >= SDPA_TENSOR_CORES_MIN_S


# the fp32 form's tiled body by S (csrc/attn_sdpa.cu): 48 query rows over
# 48-key tiles up to SDPA_F32_WIDE_MIN_S - 1 tokens
# (attn_sdpa_f32_tile_kernel; at the spatial S = 144 a head's K and V
# whole in shared memory, 240 blocks at one frame), 128 query rows over
# 64-key tiles from it (attn_sdpa_f32_wide_kernel, 4 x 8 a thread; the
# VAE's S = 576). The threshold gives the least summed time over S = 32 ..
# 577 (`python -m gtax_torch.tools.attn_sweep --f32-bodies`, both bodies
# in turns, NVIDIA H100 80GB HBM3, 700 W: the 48-row body 1.03-1.13x the
# faster at 160-384, the 128-row one 1.245x at 576; below 576 the winner
# follows the grid's waves more than S: the 128-row body at 64, 128 and
# 145; PERF.md section 6); F32_ROWS_BY_BODY: the query rows of a block of
# each
SDPA_F32_WIDE_MIN_S = 576
F32_ROWS_BY_BODY = {1: 48, 2: 128}


def sdpa_f32_body(S: int) -> int:
    """The fp32 form's body for rows of S tokens, as the C entry takes it:
    0 warp rows (below SDPA_TENSOR_CORES_MIN_S, the bf16 rule), 1 the
    tiled body's 48-row tiles, 2 its 128-row tiles (from
    SDPA_F32_WIDE_MIN_S)."""
    if not sdpa_tensor_cores(S):
        return 0
    return 2 if S >= SDPA_F32_WIDE_MIN_S else 1


def _token_rows(t, S, width, align):
    """t (..., S, width) as rows of S tokens with token stride ld and row
    stride S * ld, as the kernel reads them: ld a multiple of `align`
    elements and the pointer aligned to `align` elements (the tensor-core
    and tiled bodies read 16 bytes at a time); copied only when its layout
    is not that (a q/k/v view of a fused qkv row is read in place)."""
    ld = t.stride(-2)
    ok = (t.stride(-1) == 1 and ld >= width and ld % align == 0
          and t.data_ptr() % (align * t.element_size()) == 0)
    expect = S * ld
    for size, stride in reversed(list(zip(t.shape[:-2], t.stride()[:-2]))):
        ok = ok and (size == 1 or stride == expect)
        expect *= size
    return (t, ld) if ok else (t.contiguous(), width)


def _align(tiled: bool, dtype) -> int:
    """The elements an ld (and the pointer) must be a multiple of: 16 bytes
    for the tensor-core and tiled bodies, two elements for warp rows."""
    elem = torch.finfo(dtype).bits // 8
    return 16 // elem if tiled else 2


def _launch(q, k, v, mask, causal, S, num_heads, d):
    """out (N, S, num_heads * d), q's dtype (bf16 or fp32), of the kernel
    over the rows of q/k/v, which share their leading dims and dtype. With
    no mask and no causality the bias is all zeros, and the kernel is given
    none (its scores then add nothing, as adding +0 would)."""
    width = num_heads * d
    dt = q.dtype
    for name, t in (("q", q), ("k", k), ("v", v)):
        _need(t.is_cuda and t.dtype in (torch.bfloat16, torch.float32)
              and t.dtype == dt,
              lambda: f"{name} must be a CUDA bf16 or fp32 tensor of q's "
                      f"dtype {dt}, got {_desc(t)}")
    _need(q.shape == k.shape == v.shape,
          lambda: f"q/k/v shapes differ: {tuple(q.shape)}, "
                  f"{tuple(k.shape)}, {tuple(v.shape)}")
    _need(d in (32, 64), lambda: f"head dim {d}: the kernel takes 32 or 64")
    tc = sdpa_tensor_cores(S)
    body = sdpa_f32_body(S) if dt == torch.float32 else int(tc)
    align = _align(tc, dt)
    (q, q_ld), (k, k_ld), (v, v_ld) = (_token_rows(t, S, width, align)
                                       for t in (q, k, v))
    N = q.numel() // (S * width)
    bias = (None if mask is None and not causal
            else build_bias(S, mask, causal, q.device))
    out = torch.empty((N, S, width), dtype=dt, device=q.device)
    name = "gtax_attn_sdpa_f32" if dt == torch.float32 else "gtax_attn_sdpa"
    build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _ptr(bias), out.data_ptr(), N, S, num_heads, d, q_ld,
                 k_ld, v_ld, width, body, 1.0 / d**0.5, _stream(q))
    return out


def fused_sdpa(q, k, v, mask=None, causal=False):
    """Attention over the second-to-last axis of heads-first (..., S, d)
    tensors (gtax's sdpa semantics, scale d^-1/2); mask None, (S,) key
    validity or (S, S), True = attend. Returns None for a mask with batch
    dimensions.

    Replaces gtax/kernels/attention.py fused_sdpa (:130; _fused_sdpa_flat,
    pallas_call at :90, body _attn_kernel :60). On the card: one launch of
    attn_sdpa, a block per (query tile, row): 128 rows on the tensor cores,
    or 64 on the warp-per-row body for short rows (fp32: 48 or 128 rows of
    the tiled SIMT body by S, or warp rows). Bound: bytes (fp32:
    operations)."""
    S, d = q.shape[-2], q.shape[-1]
    if _unsupported(mask, S):
        return None
    forward_only("fused_sdpa", q, k, v)
    lead = q.shape[:-2]
    if q.device.type == "cpu":
        flat = (t.reshape(-1, S, d) for t in (q, k, v))
        return sdpa_plain(*flat, build_bias(S, mask, causal)).reshape(
            *lead, S, d)
    out = _launch(q, k, v, mask, causal, S, 1, d)
    fused_sdpa.launches += 1
    return out.reshape(*lead, S, d)


fused_sdpa.launches = 0


def fused_mha_token_major(q, k, v, num_heads, mask=None, causal=False):
    """Multi-head attention over token-major (..., S, h*d) tensors: the last
    dim split into num_heads heads of d, each attending over axis -2, the
    split never copied. mask as fused_sdpa's; returns None for a mask with
    batch dimensions.

    Replaces gtax/kernels/attention.py fused_mha_token_major (:220;
    _mha_token_major_flat, pallas_call at :198, body _mha_kernel :154). On
    the card: one launch of attn_sdpa, a block per (query tile, head, row),
    heads read as d-wide column slices in place; the tensor-core body at
    S = 144 and 576, the warp-per-row body at S = 5. Bound: bytes."""
    S, HD = q.shape[-2], q.shape[-1]
    if _unsupported(mask, S):
        return None
    forward_only("fused_mha_token_major", q, k, v)
    lead = q.shape[:-2]
    if q.device.type == "cpu":
        flat = (t.reshape(-1, S, HD) for t in (q, k, v))
        return mha_token_major_plain(*flat, build_bias(S, mask, causal),
                                     num_heads).reshape(*lead, S, HD)
    _need(HD % num_heads == 0,
          lambda: f"width {HD} is not a multiple of {num_heads} heads")
    out = _launch(q, k, v, mask, causal, S, num_heads, HD // num_heads)
    fused_mha_token_major.launches += 1
    return out.reshape(*lead, S, HD)


fused_mha_token_major.launches = 0
