"""Spatiotemporal DiT latent video denoiser (counterpart of
gtax/models/dit.py).

Blocks come in gtax's two layouts: a per-block list (the unstacked
layout, which gtax also trains in by default: `unstack_train`), or one
dict of (depth, ...) leaves (the stacked layout, gtax's `scan` layout).
dit_apply reads block i of a stacked dict as views of its leaves, with no
copy; dit_cond, dit_prefill and dit_apply_step need the unstacked layout,
as gtax's do. unstack_for_inference and restack_params convert. The
attention backend is an argument (gtax's `_block_apply`,
gtax/models/dit.py:197-357), per branch of a block:
  - W8A8 params (quantize_for_inference) take the int8 wrappers of
    gtax_torch.kernels.quant under every backend;
  - `fused` / `fused_all` take the fused attention branches, `fused_mlp` /
    `fused_all` the fused MLP branch (gtax_torch.kernels.block);
  - every other branch is unfused, x + gate(Branch(modulate(LN(x)))), with
    the attention of gtax_torch.nn.attention (its kernels under `pallas`,
    the plain path otherwise) and the layers of gtax_torch.nn.layers.
The wrappers launch the CUDA kernels for CUDA tensors and run their plain
versions for CPU tensors. dit_prefill and dit_apply_step (incremental
decoding, which serving runs under the fused backends only) take the
fused branches; there a W8A8 half-block over at most PAIR_MAX_FRAMES live
frames is one paired kernel (gtax_torch.kernels.pair), as in gtax
(gtax/models/dit.py:697-762). At B=1 the prefill has four frames and stays
sequential; every denoise step pairs.

Attention broadcast: dit_apply(collect_cache=True) also returns each
block's two gated attention deltas, and dit_apply(attn_cache=) adds them in
place of the attention branches under every backend and for W8A8 params
(gtax's _block_apply collect / attn_cache); make_pab_fns and
init_attn_cache serve the rollouts.

Training: dit_apply is differentiable under `xla`, `fused`, `fused_mlp`
and `fused_all` (dit_apply's default). Its fused bf16/fp32 branches are
the trainable branches of gtax_torch.nn.branches (the fused forward with
emit_train and the whole-branch backward kernels); with
`plain_branches=True` they are the plain `xla_*` forwards under autograd
instead, the reference the kernel path is held against. The unfused
branches are plain torch ops under autograd; under `pallas` their
attention kernels refuse a gradient, as gtax's Pallas attention has none.
`int8_fwd=True` (gtax's process-wide set_int8_fwd) runs the fused
branches' forward on the W8A8 wrappers with the bf16 backward
(gtax's int8-forward training); `DiTConfig.block_remat` recomputes each
block in the backward (torch.utils.checkpoint, gtax's jax.checkpoint with
its remat_policy). The rope frequency tables are detached, as gtax
stop_gradients them.

Parameter dict (float32 masters; Linear kernels are (in, out)):
  patch_embed {kernel,bias}
  t_embedder  {fc1{kernel,bias}, fc2{kernel,bias}}
  external_cond {kernel,bias}               (iff external_cond_dim > 0)
  spatial_rope_freqs  (head_dim//4,)   temporal_rope_freqs (head_dim//2,)
  blocks: list of {s_adaln, t_adaln {kernel,bias} (D -> 6D),
                   s_attn, t_attn {qkv{kernel}, out{kernel,bias}},
                   s_mlp, t_mlp {fc1{kernel,bias}, fc2{kernel,bias}}},
          or one such dict of (depth, ...) leaves (stacked)
  final {adaln{kernel,bias}, linear{kernel,bias}}
W8A8 params replace a block Linear's "kernel" by "kernel_q" (int8) and
"scale" (fp32, (1, out)).

Tensor parallelism (gtax's GSPMD path under a model mesh, serving and
training): with `tp=`, the model axis of params cut by
gtax_torch.parallel.mesh.shard_params, each adaLN head runs over this
rank's columns and its output is gathered whole. Under `xla` the blocks'
unfused branches run over this rank's heads and fc1 columns, and the
out-projection's and fc2's partial products are summed over the axis
before their biases. Under the fused backends each block's cut leaves are
gathered whole in front of the kernels and every model rank runs the
block over the same rows (_gather_block). The collectives are
differentiable (mesh.Axis.reduce_sum / copy_in / gather), so dit_apply
trains under tp.

`valid` (the window's slot mask) is None, a (T,) bool sequence or tensor,
or a per-row (B, T) one (gtax/models/dit.py:379). A (B, T) mask takes the
unfused temporal attention under every backend, as gtax's does: the fused
temporal branch takes a (T,) mask only, so gtax falls through to its XLA
branch there (gtax/models/dit.py:326-328), and under `pallas` the
token-major kernel takes (T, T) masks only. W8A8 params refuse it
(ValueError), as gtax asserts (gtax/models/dit.py:305-306).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from gtax_torch.core import rope
from gtax_torch.kernels import backward, block, pair, quant
from gtax_torch.nn import attention as attn
from gtax_torch.nn import branches
from gtax_torch.nn.layers import (
    gate,
    gelu_tanh,
    layer_norm,
    linear,
    mlp,
    modulate,
    patchify_embed,
    timestep_embedder,
)
from gtax_torch.parallel import mesh as meshlib


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_h: int = 18
    input_w: int = 32
    patch_size: int = 2
    in_channels: int = 16
    hidden_size: int = 1024
    depth: int = 16
    num_heads: int = 16
    mlp_ratio: float = 4.0
    external_cond_dim: int = 25
    max_frames: int = 5
    # recompute each block in the backward (gtax DiTConfig.block_remat):
    # the backward keeps only the blocks' inputs. remat_policy "full"
    # recomputes the whole block; "dots" keeps every product's output
    # (mm, addmm, bmm), "dots_nb" only the unbatched ones (mm, addmm: the
    # projections), gtax's checkpoint_dots / _with_no_batch_dims. The
    # kernels' autograd Functions are recomputed under every policy, as
    # gtax's Pallas calls are.
    block_remat: bool = False
    remat_policy: str = "full"

    @property
    def grid_h(self) -> int:
        return self.input_h // self.patch_size

    @property
    def grid_w(self) -> int:
        return self.input_w // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


def dit_init(cfg: DiTConfig, generator: torch.Generator, device="cpu"):
    """Initialise DiT params like gtax dit_init (reference
    initialize_weights): linears normal(0.02) with zero bias, t_embedder
    normal(0.01), adaLN heads ZERO (every block starts as the identity),
    final adaLN normal(0.01), final linear normal(0.001). Random numbers come
    from `generator`; they are not JAX's."""
    D, H4, H6 = cfg.hidden_size, cfg.mlp_hidden, 6 * cfg.hidden_size
    p, C = cfg.patch_size, cfg.in_channels

    def lin(din, dout, std=0.02, bias=True, zero=False):
        if zero:
            w = torch.zeros((din, dout), device=device)
        else:
            w = torch.randn((din, dout), generator=generator,
                            device=device) * std
        prm = {"kernel": w}
        if bias:
            prm["bias"] = torch.zeros((dout,), device=device)
        return prm

    def branch():
        return {
            "adaln": lin(D, H6, zero=True),
            "attn": {"qkv": lin(D, 3 * D, bias=False), "out": lin(D, D)},
            "mlp": {"fc1": lin(D, H4), "fc2": lin(H4, D)},
        }

    blocks = []
    for _ in range(cfg.depth):
        s, t = branch(), branch()
        blocks.append({
            "s_adaln": s["adaln"], "s_attn": s["attn"], "s_mlp": s["mlp"],
            "t_adaln": t["adaln"], "t_attn": t["attn"], "t_mlp": t["mlp"],
        })
    params = {
        "patch_embed": lin(C * p * p, D),
        "t_embedder": {"fc1": lin(256, D, std=0.01),
                       "fc2": lin(D, D, std=0.01)},
        "spatial_rope_freqs": rope.pixel_freqs(cfg.head_dim // 2,
                                               max_freq=256.0).to(device),
        "temporal_rope_freqs": rope.lang_freqs(cfg.head_dim).to(device),
        "blocks": blocks,
        "final": {"adaln": lin(D, 2 * D, std=0.01),
                  "linear": lin(D, p * p * C, std=0.001)},
    }
    if cfg.external_cond_dim > 0:
        params["external_cond"] = lin(cfg.external_cond_dim, D)
    return params


def _map_params(params, fn, path=()):
    if isinstance(params, dict):
        return {k: _map_params(v, fn, path + (k,)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_map_params(v, fn, path + (i,)) for i, v in enumerate(params)]
    return fn(path, params)


def cast_params_for_inference(params, dtype=torch.bfloat16):
    """Pre-cast every floating weight to the compute dtype once for serving
    (either layout); the rotary frequency tables stay fp32 (their phases
    would not survive bf16), and so do the scales of W8A8 params (the int8
    kernels read fp32), should the params be quantized already."""

    def cast(path, leaf):
        if path[-1] in ("spatial_rope_freqs", "temporal_rope_freqs", "scale"):
            return leaf
        return leaf.to(dtype) if leaf.is_floating_point() else leaf

    return _map_params(params, cast)


def quantize_for_inference(params):
    """W8A8 serving params (gtax quantize_for_inference with its default
    adaln=True): every block's qkv/out/fc1/fc2 kernel of both halves and its
    two adaLN heads become {"kernel_q": int8, "scale": fp32 (1, out)} plus
    the bias. The embedders and the final layer stay in the compute dtype.
    Apply after cast_params_for_inference; the result serves inference
    only, and quantizing it again changes nothing. Either layout: a
    stacked (depth, in, out) kernel quantizes with per-block scales. On
    the card the int8 kernels are stored as the int8 tensor cores read
    them (quant.card_layout), already quantized ones included."""

    def qlin(d):
        if "kernel_q" in d:
            q = d["kernel_q"]
            return dict(d, kernel_q=quant.card_layout(q)) if q.is_cuda else d
        q, s = quant.quantize_weight(d["kernel"])
        return {"kernel_q": q, "scale": s,
                **({"bias": d["bias"]} if "bias" in d else {})}

    def qblock(bp):
        nbp = {k: dict(v) for k, v in bp.items()}
        for half in ("s", "t"):
            for name in ("qkv", "out"):
                nbp[f"{half}_attn"][name] = qlin(bp[f"{half}_attn"][name])
            for name in ("fc1", "fc2"):
                nbp[f"{half}_mlp"][name] = qlin(bp[f"{half}_mlp"][name])
            nbp[f"{half}_adaln"] = qlin(bp[f"{half}_adaln"])
        return nbp

    blocks = params["blocks"]
    return dict(params, blocks=qblock(blocks) if is_stacked(params)
                else [qblock(bp) for bp in blocks])


def is_stacked(params) -> bool:
    """True for the stacked layout: blocks is one dict of (depth, ...)
    leaves."""
    return isinstance(params["blocks"], dict)


def _unbind(tree):
    """Per-block views of a stacked block dict (unbind: the backward stacks
    the blocks' gradients into the stacked leaf's once, where indexing
    would add a zero-filled full-size gradient per block)."""
    flat = {}
    _map_params(tree, lambda path, leaf: flat.__setitem__(path,
                                                          leaf.unbind(0)))
    depth = len(next(iter(flat.values())))
    return [_map_params(tree, lambda path, _, i=i: flat[path][i])
            for i in range(depth)]


def _blocks(params):
    """The blocks as a per-block list, in either layout."""
    blocks = params["blocks"]
    return _unbind(blocks) if is_stacked(params) else list(blocks)


def _need_unstacked(params, what):
    if is_stacked(params):  # gtax/models/dit.py:603-609, :778
        raise ValueError(f"{what} requires the unstacked serving layout "
                         "(unstack_for_inference)")


def unstack_for_inference(params, cfg: DiTConfig):
    """The stacked layout as gtax's unstacked one (gtax
    unstack_for_inference, gtax/models/dit.py:891): block i's leaves are
    views leaf[i] of the stacked leaves, no copy. Unchanged if already
    unstacked."""
    blocks = _blocks(params)
    if len(blocks) != cfg.depth:
        raise ValueError(f"{len(blocks)} blocks for depth {cfg.depth}")
    return params if not is_stacked(params) else dict(params, blocks=blocks)


def restack_params(params, cfg: DiTConfig):
    """The inverse (gtax restack_params, :916): per-block leaves stacked
    into (depth, ...) leaves, a copy. Unchanged if already stacked."""
    if is_stacked(params):
        return params
    blocks = params["blocks"]
    if len(blocks) != cfg.depth:
        raise ValueError(f"{len(blocks)} blocks for depth {cfg.depth}")
    flat = {}
    for bp in blocks:
        _map_params(bp, lambda path, leaf: flat.setdefault(path, []).append(
            leaf))
    return dict(params, blocks=_map_params(
        blocks[0], lambda path, _: torch.stack(flat[path])))


def quantize_train_weights(params, compute_dtype=torch.bfloat16):
    """The int8 forward's weights for every block (dit_apply's
    int8_weights): for each of s_attn, t_attn, s_mlp and t_mlp, the int8
    values and fp32 scales of its two kernels cast to the compute dtype
    (branches.int8_weights), without gradient. The trainer makes them once
    per optimizer step: the weights do not change across its micro-steps,
    so each micro-step would quantize to the same bits. A stacked layout
    quantizes each stacked kernel at once (per-block scales: the same
    bits)."""
    names = {"s_attn": ("qkv", "out"), "t_attn": ("qkv", "out"),
             "s_mlp": ("fc1", "fc2"), "t_mlp": ("fc1", "fc2")}
    stacked = is_stacked(params)
    blocks = [params["blocks"]] if stacked else params["blocks"]
    out = [{key: branches.int8_weights(
        *(bp[key][n]["kernel"].to(compute_dtype) for n in pair))
        for key, pair in names.items()} for bp in blocks]
    if not stacked:
        return out
    return [{key: tuple(t[i] for t in ws) for key, ws in out[0].items()}
            for i in range(out[0]["s_attn"][0].shape[0])]


def params_to(params, device):
    """Move every tensor of a param dict to `device`."""
    return _map_params(params, lambda _, leaf: leaf.to(device))


def _rope_tables(params, cfg: DiTConfig, T: int):
    """(spatial (S, head_dim), temporal (T, head_dim)) fp32 tables."""
    gh, gw = cfg.grid_h, cfg.grid_w
    spatial = rope.axial_freqs(params["spatial_rope_freqs"].detach().float(),
                               (gh, gw), pixel=True).reshape(gh * gw, -1)
    temporal = rope.temporal_rope_freqs(
        torch.arange(T, device=params["temporal_rope_freqs"].device),
        params["temporal_rope_freqs"].detach())
    return spatial.contiguous(), temporal.contiguous()


def _embed(params, cfg, x, compute_dtype):
    """Patch-embed (B, T, C, H, W) latents into (B*T, S, D) tokens."""
    B, T, C, H, W = x.shape
    h = patchify_embed(params["patch_embed"], x.reshape(B * T, C, H, W),
                       cfg.patch_size, compute_dtype)
    return h.reshape(B * T, cfg.grid_h * cfg.grid_w, cfg.hidden_size)


def _split6(m, rows, D):
    """(B, T, 6D) adaLN head output -> six (rows, D) views."""
    return [a.reshape(rows, D) for a in m.split(D, dim=-1)]


def _attn_weights(ap):
    """(W8A8?, the weight arguments of the attention branch wrappers):
    (qkv, out, out_b) in the compute dtype, or (qkv_q, qkv_s, out_q, out_s,
    out_b)."""
    qkv, out = ap["qkv"], ap["out"]
    if "kernel_q" in qkv:
        return True, (qkv["kernel_q"], qkv["scale"], out["kernel_q"],
                      out["scale"], out["bias"])
    return False, (qkv["kernel"], out["kernel"], out["bias"])


def _plain(fn):
    def call(x, *args):
        return fn(x, *args, x.dtype)
    return call


# (spatial, temporal, MLP) branch functions of the bf16/fp32 blocks: the
# trainable kernel branches (plain wrapper calls when no gradient is
# needed), or the plain xla_* forwards under autograd
KERNEL_BRANCHES = (branches.trainable_spatial_branch,
                   branches.trainable_temporal_branch,
                   branches.trainable_mlp_branch)
PLAIN_BRANCHES = tuple(_plain(fn) for fn in (branches.xla_spatial_branch,
                                             branches.xla_temporal_branch,
                                             branches.xla_mlp_branch))


def _mlp_weights(mp):
    """(W8A8?, the weight arguments of the MLP branch wrappers)."""
    f1, f2 = mp["fc1"], mp["fc2"]
    if "kernel_q" in f1:
        return True, (f1["kernel_q"], f1["scale"], f1["bias"], f2["kernel_q"],
                      f2["scale"], f2["bias"])
    return False, (f1["kernel"], f1["bias"], f2["kernel"], f2["bias"])


def _mlp(mp, h, sh, sc, g, fns=KERNEL_BRANCHES, fused=True, qw=None,
         tp=None):
    """The MLP branch over (rows, S, D) tokens: int8 or fused wrappers (the
    fused one's int8 forward given qw), or unfused, x +
    gate(mlp(modulate(LN(x)))) (gtax's XLA path; tp: fc1 over this rank's
    columns, fc2's partial products summed over the model ranks)."""
    q8, w = _mlp_weights(mp)
    if q8:
        return quant.fused_mlp_branch_q(h, sh, sc, g, *w)
    if fused:
        return fns[2](h, sh, sc, g, *w, **({} if qw is None else {"qw": qw}))
    x = modulate(layer_norm(h), sh, sc)
    if tp is not None:
        x = tp.copy_in(x)
    return h + gate(mlp(mp, x, gelu_tanh, h.dtype,
                        None if tp is None else tp.reduce_sum), g)


def _unfused_attention(fn, ap, h, sh, sc, g, grid, freqs, num_heads,
                       backend, tp=None, **kw):
    """x + gate(Attention(modulate(LN(x)))) through gtax_torch.nn.attention,
    on the (B, T, gh, gw, D) view `grid` of the (B*T, S, D) tokens; tp:
    over this rank's heads, the out-projection summed over the ranks."""
    x = h.reshape(grid)
    sh, sc, g = (t.reshape(*grid[:2], -1) for t in (sh, sc, g))
    y = modulate(layer_norm(x), sh, sc)
    if tp is not None:
        y, kw = tp.copy_in(y), dict(kw, reduce=tp.reduce_sum)
    a = fn(ap, y, freqs, num_heads, compute_dtype=h.dtype, backend=backend,
           **kw)
    return (x + gate(a, g)).reshape(h.shape)


def _gather_block(bp, tp):
    """A block of params cut over `tp` (its GEMM kernels already in the
    compute dtype), with every cut leaf of its branches gathered whole
    (differentiably: each rank's gradient is its slice of the whole one;
    the adaLN heads stay cut: _cond runs them over the axis). Returns
    (block, recipes): recipes maps each gathered tensor's storage to how
    to gather it again, for _regathered."""
    recipes = {}

    def whole(path, leaf):
        dim = meshlib.spec_dim(("blocks",) + path, leaf.dim())
        if dim is None or "adaln" in path[0]:
            return leaf
        qkv = "qkv" in path
        full = tp.gather(leaf, dim, qkv)
        recipes[full.data_ptr()] = (leaf.detach(), dim, qkv, full.shape)
        return full

    return _map_params(bp, whole), recipes


def _regathered(tp, recipes):
    """saved_tensors_hooks that keep a gathered weight's shard, not the
    whole weight, for the backward, and gather it again there: the whole
    copy is freed once the block's forward ends, as remat frees it (every
    model rank unpacks in the same order: the graphs are the same)."""

    def pack(t):
        r = recipes.get(t.data_ptr())
        return t if r is None or r[3] != t.shape else r

    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        shard, dim, qkv, _ = saved
        with torch.no_grad():
            return tp.all_gather(shard, dim, qkv)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def _spatial_pair(bp, h, m, rows, D, freqs, num_heads, fns=KERNEL_BRANCHES):
    """Spatial attention + spatial MLP of one block on the fused path of
    dit_prefill / dit_apply_step: one paired kernel for a W8A8 block over
    at most PAIR_MAX_FRAMES frames (gtax _spatial_pair_call), else the two
    branch wrappers."""
    sh1, sc1, g1, sh2, sc2, g2 = _split6(m, rows, D)
    q8, w = _attn_weights(bp["s_attn"])
    if q8 and rows <= pair.PAIR_MAX_FRAMES:
        return pair.fused_spatial_pair_q(
            h, sh1, sc1, g1, sh2, sc2, g2, *w, *_mlp_weights(bp["s_mlp"])[1],
            freqs, num_heads)
    fn = quant.fused_spatial_branch_q if q8 else fns[0]
    h = fn(h, sh1, sc1, g1, *w, freqs, num_heads)
    return _mlp(bp["s_mlp"], h, sh2, sc2, g2, fns)


def _cast_weights(bp, dtype):
    """A block's GEMM weights in the compute dtype; returns bp itself once
    cast_params_for_inference ran (the serving path) or for W8A8 blocks."""
    qkv = bp["s_attn"]["qkv"]
    if "kernel_q" in qkv or qkv["kernel"].dtype == dtype:
        return bp
    return _map_params(
        bp, lambda path, leaf: leaf.to(dtype) if path[-1] == "kernel"
        else leaf)


# the products whose outputs the "dots" policies keep (torch's aten ops
# for gtax's dot_general, batched or not)
_DOTS = {"dots": ("mm", "addmm", "bmm"), "dots_nb": ("mm", "addmm")}


def _remat_context(policy: str):
    """checkpoint's context_fn for a remat_policy: None for "full"
    (recompute everything), else selective checkpointing that keeps the
    outputs of the policy's products."""
    if policy == "full":
        return None
    if policy not in _DOTS:
        raise ValueError(f"remat_policy {policy!r}: one of 'full', "
                         f"{', '.join(map(repr, _DOTS))}")
    keep = {getattr(torch.ops.aten, n).default for n in _DOTS[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in keep
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy_fn)


def _check_int8_fwd(backend, plain_branches):
    if backend not in attn.FUSED_ATTENTION:  # gtax/train/trainer.py:123
        raise ValueError(f"int8_fwd runs through the fused trainable "
                         f"branches: backend 'fused' or 'fused_all', not "
                         f"{backend!r}")
    if plain_branches:
        raise ValueError("int8_fwd has no plain_branches form")


def _check_tp(params, backend, plain_branches, int8_weights):
    if (backend == "pallas" or plain_branches
            or "kernel_q" in _blocks(params)[0]["s_attn"]["qkv"]):
        raise ValueError("tensor-parallel params run the `xla` backend's "
                         "unfused bf16/fp32 branches over the model axis "
                         "(gtax's GSPMD path) or the fused ones on gathered "
                         f"blocks; not backend {backend!r}, the plain kernel "
                         "branches or W8A8 params")
    if int8_weights is not None:
        raise ValueError("under tp the int8 forward quantizes each gathered "
                         "block itself: int8_weights of cut kernels would "
                         "take the shards' scales")


def dit_apply(params, cfg: DiTConfig, x, t=None, external_cond=None,
              valid=None, compute_dtype=torch.bfloat16, mods=None,
              plain_branches=False, backend="fused_all", attn_cache=None,
              collect_cache=False, int8_fwd=False, int8_weights=None,
              tp=None):
    """Full-window forward. x: (B, T, C, H, W) latents; t: (B, T) integer
    noise levels; external_cond: optional (B, T, action_dim); valid:
    optional (T,) or per-row (B, T) mask of real frames (module
    docstring). With `mods` (dit_cond output) the
    adaLN heads are skipped and t/external_cond are ignored (the unstacked
    layout only). `backend` picks each branch's path (module docstring;
    gtax's five names). Returns the v-prediction, x's shape, float32.
    Differentiable (plain_branches picks the plain xla_* branches for the
    fused ones).

    int8_fwd: the fused branches of bf16/fp32 blocks run the W8A8 forward
    (backend `fused` or `fused_all`; under `fused` the MLP stays the
    unfused path, as in gtax), on int8_weights (quantize_train_weights of
    these params) or, by default, quantizing each block's compute-dtype
    kernels itself. With cfg.block_remat each block is recomputed in the
    backward under cfg.remat_policy.

    Attention broadcast (gtax _block_apply's collect / attn_cache):
    collect_cache=True also returns each block's two attention branches'
    gated residual deltas (x_after - x_before, (B, T, gh, gw, D) in the
    compute dtype), a list of (delta_s, delta_t) pairs, one per block;
    attn_cache=<that list> skips every attention branch and adds the
    cached delta instead. The MLP branches always run.

    tp: the model axis (gtax_torch.parallel.mesh.Axis) of params cut by
    mesh.shard_params (gtax's tensor parallelism; module docstring): under
    `xla` each rank attends over its heads and runs fc1 over its columns,
    the out-projection's and fc2's partial products summed over the axis
    before their biases; under `fused`, `fused_mlp` and `fused_all` each
    block's cut leaves are gathered whole in front of the branches. Each
    adaLN head's output is gathered whole. Differentiable; the int8
    forward quantizes each gathered block itself (no int8_weights)."""
    attn.check_backend(backend)
    if int8_fwd:
        _check_int8_fwd(backend, plain_branches)
    if tp is not None:
        _check_tp(params, backend, plain_branches, int8_weights)
    remat = cfg.block_remat and torch.is_grad_enabled()
    if remat and (collect_cache or attn_cache is not None):
        raise ValueError("attention broadcast is inference-only: not with "
                         "block_remat under autograd")
    B, T = x.shape[:2]
    D, H = cfg.hidden_size, cfg.num_heads
    fns = PLAIN_BRANCHES if plain_branches else KERNEL_BRANCHES
    fused_attn = backend in attn.FUSED_ATTENTION
    fused_mlp = backend in attn.FUSED_MLP
    blocks = _blocks(params)
    if mods is None:
        mods = _cond(params, blocks, cfg, t, external_cond, compute_dtype,
                     tp)
    else:
        _need_unstacked(params, "dit_apply(mods=...)")
    spatial, temporal = _rope_tables(params, cfg, T)
    # the spatial backward's cos and sin of its table, formed once for all
    # the blocks (the kernel path's attn_frame_bwd reads them)
    rope_cs = (backward.rope_tables(spatial)
               if fused_attn and not plain_branches and spatial.is_cuda
               and torch.is_grad_enabled() else None)
    grid = (B, T, cfg.grid_h, cfg.grid_w, D)
    spatial_grid = spatial.reshape(cfg.grid_h, cfg.grid_w, -1)
    rows = B * T
    # under the fused backends a tensor-parallel block runs whole, on its
    # gathered leaves (module docstring); under `xla` over its shards
    gather_blocks = tp is not None and backend != "xla"
    block_tp = None if gather_blocks else tp
    # a per-row (B, T) mask: the unfused temporal attention (module
    # docstring)
    row_mask = valid is not None and torch.as_tensor(valid).dim() == 2

    def block_fn(h, i):
        bp = _cast_weights(blocks[i], compute_dtype)
        if not gather_blocks:
            return block_body(h, i, bp)
        # gtax compiles a fused branch with GSPMD, which cannot cut a
        # pallas_call: XLA gathers the block's weights whole in front of
        # it, and every model rank runs it over its data index's rows. The
        # ranks' whole weight gradients then agree, and each keeps its
        # slice (no sum over the model axis)
        bp, recipes = _gather_block(bp, tp)
        if not torch.is_grad_enabled() or remat:  # remat's recompute gathers
            return block_body(h, i, bp)
        with _regathered(tp, recipes):
            return block_body(h, i, bp)

    def block_body(h, i, bp):
        m = mods["blocks"][i]
        qws = None
        if int8_fwd and "kernel_q" not in bp["s_attn"]["qkv"]:
            qws = (int8_weights[i] if int8_weights is not None
                   else quantize_train_weights({"blocks": [bp]},
                                               compute_dtype)[0])
        pair_deltas = []
        for j, (half, freqs) in enumerate((("s", spatial), ("t", temporal))):
            sh1, sc1, g1, sh2, sc2, g2 = _split6(m[half], rows, D)
            ap = bp[f"{half}_attn"]
            q8, w = _attn_weights(ap)
            qw = {} if qws is None else {"qw": qws[f"{half}_attn"]}
            h_pre = h
            if attn_cache is not None:
                h = h + attn_cache[i][j].reshape(h.shape).to(h.dtype)
            elif half == "s" and (q8 or fused_attn):
                fn = quant.fused_spatial_branch_q if q8 else fns[0]
                kw = {} if q8 or rope_cs is None else {"rope_cs": rope_cs}
                h = fn(h, sh1, sc1, g1, *w, freqs, H, **kw, **qw)
            elif half == "t" and q8 and row_mask:
                raise ValueError("quantized params serve inference rollouts "
                                 "only (valid must be None or a (T,) mask)")
            elif half == "t" and (q8 or (fused_attn and not row_mask)):
                fn = quant.fused_temporal_branch_q if q8 else fns[1]
                h = fn(h, sh1, sc1, g1, *w, freqs, valid, H, T, **qw)
            elif half == "s":
                h = _unfused_attention(attn.spatial_axial_attention, ap, h,
                                       sh1, sc1, g1, grid, spatial_grid, H,
                                       backend, block_tp)
            else:
                h = _unfused_attention(attn.temporal_axial_attention, ap, h,
                                       sh1, sc1, g1, grid, freqs, H, backend,
                                       block_tp, valid=valid)
            if collect_cache:
                pair_deltas.append((h - h_pre).to(compute_dtype).reshape(
                    grid))
            mqw = None if qws is None else qws[f"{half}_mlp"]
            h = _mlp(bp[f"{half}_mlp"], h, sh2, sc2, g2, fns, fused_mlp, mqw,
                     block_tp)
        return h, tuple(pair_deltas)

    h = _embed(params, cfg, x, compute_dtype)
    context = _remat_context(cfg.remat_policy) if remat else None
    deltas = []
    for i in range(len(blocks)):
        if remat:
            # the block draws nothing: no RNG state to replay
            h = ckpt.checkpoint(lambda h, i=i: block_fn(h, i)[0], h,
                                use_reentrant=False, preserve_rng_state=False,
                                **({} if context is None
                                   else {"context_fn": context}))
        else:
            h, pair_deltas = block_fn(h, i)
            deltas.append(pair_deltas)
    v = _dit_head(params, cfg, h, mods["final"], B, T, compute_dtype)
    return (v, deltas) if collect_cache else v


def _dit_head(params, cfg, h, final_mods, B, T, compute_dtype):
    """FinalLayer + unpatchify (patch features ordered (ph, pw, channel))."""
    gh, gw, p, C = cfg.grid_h, cfg.grid_w, cfg.patch_size, cfg.in_channels
    shift, scale = final_mods.chunk(2, dim=-1)
    h = h.reshape(B, T, gh, gw, cfg.hidden_size)
    h = modulate(layer_norm(h), shift, scale)
    h = linear(params["final"]["linear"], h, compute_dtype)
    h = h.reshape(B, T, gh, gw, p, p, C).permute(0, 1, 6, 2, 4, 3, 5)
    return h.reshape(B, T, C, gh * p, gw * p).float()


def dit_cond(params, cfg: DiTConfig, t, external_cond=None,
             compute_dtype=torch.bfloat16):
    """Every conditioning-derived tensor of the forward: per block the
    spatial/temporal adaLN head outputs, plus the FinalLayer adaLN.
    t: (B, T) int; external_cond: optional (B, T, A). Returns
    {"blocks": [{"s", "t"}: (B, T, 6D)], "final": (B, T, 2D)} in the
    compute dtype. The unstacked layout only, as gtax's."""
    _need_unstacked(params, "dit_cond")
    return _cond(params, params["blocks"], cfg, t, external_cond,
                 compute_dtype)


def _cond(params, blocks, cfg, t, external_cond, compute_dtype, tp=None):
    """dit_cond over the per-block list `blocks`; with tp (dit_apply's),
    each adaLN head's columns are this rank's, gathered whole (the final
    adaLN is replicated and takes the rows as they are)."""
    B, T = t.shape
    c = timestep_embedder(params["t_embedder"], t.reshape(B * T),
                          compute_dtype=compute_dtype)
    c = c.reshape(B, T, cfg.hidden_size)
    if external_cond is not None:
        c = c + linear(params["external_cond"], external_cond, compute_dtype)
    h = F.silu(c.float()).to(compute_dtype)
    if tp is None:
        heads = [{"s": linear(bp["s_adaln"], h, compute_dtype),
                  "t": linear(bp["t_adaln"], h, compute_dtype)}
                 for bp in blocks]
    else:  # one sum of the rows' gradient over the ranks for every head
        hc = tp.copy_in(h)
        heads = [{"s": tp.gather(linear(bp["s_adaln"], hc, compute_dtype)),
                  "t": tp.gather(linear(bp["t_adaln"], hc, compute_dtype))}
                 for bp in blocks]
    return {"blocks": heads,
            "final": linear(params["final"]["adaln"], h, compute_dtype)}


def dit_prefill(params, cfg: DiTConfig, x_ctx, mods, valid_ctx,
                compute_dtype=torch.bfloat16):
    """Context prefill for incremental decoding: the blocks over the Tc
    context frames only, returning each block's post-rope temporal (K, V)
    rows, (B*Tc*S, D) in the compute dtype (the temporal branch's emit_kv
    output). The unstacked layout only."""
    _need_unstacked(params, "dit_prefill")
    B, Tc = x_ctx.shape[:2]
    D, S = cfg.hidden_size, cfg.grid_h * cfg.grid_w
    spatial, temporal = _rope_tables(params, cfg, Tc)
    h = _embed(params, cfg, x_ctx, compute_dtype)
    rows = B * Tc
    kv = []
    for bp, m in zip(params["blocks"], mods["blocks"]):
        bp = _cast_weights(bp, compute_dtype)
        h = _spatial_pair(bp, h, m["s"], rows, D, spatial, cfg.num_heads)
        th1, tc1, tg1, th2, tc2, tg2 = _split6(m["t"], rows, D)
        q8, w = _attn_weights(bp["t_attn"])
        fn = (quant.fused_temporal_branch_q if q8
              else block.fused_temporal_branch)
        h, kk, vv = fn(h, th1, tc1, tg1, *w, temporal, valid_ctx,
                       cfg.num_heads, Tc, emit_kv=True)
        kv.append((kk.reshape(B * Tc * S, D), vv.reshape(B * Tc * S, D)))
        h = _mlp(bp["t_mlp"], h, th2, tc2, tg2)
    return kv


def dit_apply_step(params, cfg: DiTConfig, x_last, kv_cache, mods, valid,
                   compute_dtype=torch.bfloat16):
    """Incremental forward: only the window's last Tl slots through the
    stack, temporal attention reading the prefilled context K/V. x_last:
    (B, Tl, C, H, W); kv_cache: dit_prefill output; mods: dit_cond output
    for the live rows; valid: full-window (T,) mask or None. Returns the
    live frames' v-prediction, (B, Tl, C, H, W) float32. The unstacked
    layout only."""
    _need_unstacked(params, "dit_apply_step")
    B, Tl = x_last.shape[:2]
    D, T = cfg.hidden_size, cfg.max_frames
    n_ctx = T - Tl
    spatial, temporal = _rope_tables(params, cfg, T)
    h = _embed(params, cfg, x_last, compute_dtype)
    rows = B * Tl
    for bp, m, (k_ctx, v_ctx) in zip(params["blocks"], mods["blocks"],
                                     kv_cache):
        bp = _cast_weights(bp, compute_dtype)
        h = _spatial_pair(bp, h, m["s"], rows, D, spatial, cfg.num_heads)
        th1, tc1, tg1, th2, tc2, tg2 = _split6(m["t"], rows, D)
        q8, w = _attn_weights(bp["t_attn"])
        if q8 and rows <= pair.PAIR_MAX_FRAMES:
            h = pair.fused_temporal_pair_q(
                h, th1, tc1, tg1, th2, tc2, tg2, *w,
                *_mlp_weights(bp["t_mlp"])[1], k_ctx, v_ctx, temporal, valid,
                cfg.num_heads, n_ctx, n_live=Tl)
            continue
        fn = quant.fused_temporal_step_q if q8 else block.fused_temporal_step
        h = fn(h, th1, tc1, tg1, *w, k_ctx, v_ctx, temporal, valid,
               cfg.num_heads, n_ctx, n_live=Tl)
        h = _mlp(bp["t_mlp"], h, th2, tc2, tg2)
    return _dit_head(params, cfg, h, mods["final"], B, Tl, compute_dtype)


def make_cond_fns(cfg: DiTConfig, compute_dtype=torch.bfloat16,
                  backend="fused_all"):
    """(cond_fn, apply_fn) for the rollout's conditioning cache."""

    def cond_fn(params, t, a):
        return dit_cond(params, cfg, t, a, compute_dtype)

    def apply_fn(params, x, mods, valid):
        return dit_apply(params, cfg, x, valid=valid,
                         compute_dtype=compute_dtype, mods=mods,
                         backend=backend)

    return cond_fn, apply_fn


def make_incremental_fns(cfg: DiTConfig, compute_dtype=torch.bfloat16):
    """(prefill_fn, step_fn) for the rollout's incremental decoding."""

    def prefill_fn(params, x_ctx, mods_ctx, valid_ctx):
        return dit_prefill(params, cfg, x_ctx, mods_ctx, valid_ctx,
                           compute_dtype)

    def step_fn(params, x_last, kv_cache, mods_last, valid):
        return dit_apply_step(params, cfg, x_last, kv_cache, mods_last,
                              valid, compute_dtype)

    return prefill_fn, step_fn


def init_attn_cache(cfg: DiTConfig, B: int, T: int,
                    compute_dtype=torch.bfloat16, device="cpu"):
    """Zero attention-broadcast cache in dit_apply(collect_cache=True)'s
    layout: one (delta_s, delta_t) pair per block, each (B, T, gh, gw, D)
    in the compute dtype (gtax init_attn_cache, unstacked layout)."""
    z = torch.zeros((B, T, cfg.grid_h, cfg.grid_w, cfg.hidden_size),
                    dtype=compute_dtype, device=device)
    return [(z, z) for _ in range(cfg.depth)]


def make_pab_fns(cfg: DiTConfig, compute_dtype=torch.bfloat16,
                 backend="fused_all", tp=None):
    """(collect_fn, reuse_fn, init_cache_fn) for the rollouts' attention
    broadcast (make_rollout(pab=) / make_pipelined_rollout(pab=)); tp as
    dit_apply's."""

    def collect(params, x, t, a, valid):
        return dit_apply(params, cfg, x, t, a, valid,
                         compute_dtype=compute_dtype, backend=backend,
                         collect_cache=True, tp=tp)

    def reuse(params, x, t, a, valid, cache):
        return dit_apply(params, cfg, x, t, a, valid,
                         compute_dtype=compute_dtype, backend=backend,
                         attn_cache=cache, tp=tp)

    def init_cache(params, B, T):
        return init_attn_cache(cfg, B, T, compute_dtype,
                               params["patch_embed"]["kernel"].device)

    return collect, reuse, init_cache


def DiT_S_2() -> DiTConfig:
    """Flagship config, ~0.67B params."""
    return DiTConfig(input_h=18, input_w=32, patch_size=2, hidden_size=1024,
                     depth=16, num_heads=16, max_frames=5,
                     external_cond_dim=25)


def DiT_debug() -> DiTConfig:
    """Tiny preset (pairs with 'vae-debug': latent 8ch on a 6x8 grid)."""
    return DiTConfig(input_h=6, input_w=8, patch_size=2, in_channels=8,
                     hidden_size=64, depth=2, num_heads=2, max_frames=5,
                     external_cond_dim=25)


DiT_MODELS = {"DiT-S/2": DiT_S_2, "DiT-debug": DiT_debug}
