"""Reference checkpoints and gtax parameter trees -> the port's parameters
(counterpart of gtax/io/safetensors_port.py).

The safetensors format is parsed directly (the serving machine has no
`safetensors` package): an 8-byte little-endian header length, a JSON
header of {name: {dtype, shape, data_offsets}}, then the raw buffers. bf16
tensors are read through torch.frombuffer and, like gtax's reader, upcast
to float32.

Layout mappings (torch state_dict -> port), as in gtax:
  - nn.Linear weight (out, in)              -> kernel (in, out)
  - patch-embed Conv2d weight (D, C, p, p)  -> kernel (C*p*p, D)
  - per-block tensors blocks.{i}.X          -> blocks[i]
  - rotary freqs nn.Parameters              -> {spatial,temporal}_rope_freqs

The weight bridge (`dit_from_gtax`, `vae_from_gtax`) takes gtax parameter
pytrees as nested dicts of numpy arrays, with stacked (leading depth axis)
or unstacked (list of per-block dicts) blocks, so that both frameworks
compute the same function from the same weights. A W8A8 tree (gtax
quantize_for_inference) carries across too: its int8 "kernel_q" leaves stay
int8, every float leaf (scales, biases) becomes fp32.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from gtax_torch.core import rope

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors (bf16 upcast to fp32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        t = t.reshape(info["shape"]).clone()
        out[name] = t.float() if dtype == torch.bfloat16 else t
    return out


def strip_prefix(state: dict, prefix: str = "module.") -> dict:
    """Drop a DDP/compile wrapper prefix if every key has it."""
    if state and all(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items()}
    return state


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _t(x):  # torch Linear weight -> kernel (in, out)
    return _f32(x).T.contiguous()


def _conv_kernel(x):  # (D, C, p, p) -> (C*p*p, D)
    x = _f32(x)
    return x.reshape(x.shape[0], -1).T.contiguous()


# ----------------------------------------------------------------- DiT

_DIT_BLOCK_LIN = {
    # port path inside a block -> (torch suffix, has_bias)
    ("s_adaln",): ("s_adaLN_modulation.1", True),
    ("s_attn", "qkv"): ("s_attn.to_qkv", False),
    ("s_attn", "out"): ("s_attn.to_out", True),
    ("s_mlp", "fc1"): ("s_mlp.fc1", True),
    ("s_mlp", "fc2"): ("s_mlp.fc2", True),
    ("t_adaln",): ("t_adaLN_modulation.1", True),
    ("t_attn", "qkv"): ("t_attn.to_qkv", False),
    ("t_attn", "out"): ("t_attn.to_out", True),
    ("t_mlp", "fc1"): ("t_mlp.fc1", True),
    ("t_mlp", "fc2"): ("t_mlp.fc2", True),
}


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def dit_from_torch(state: dict, cfg):
    """Port DiT params from a torch state_dict. Returns (params, missing,
    unexpected); like gtax, missing keys are reported, not fatal."""
    used: set[str] = set()
    missing: list[str] = []

    def take(key, fn=_f32):
        if key not in state:
            missing.append(key)
            return None
        used.add(key)
        return fn(state[key])

    def take_rope(canonical, alias_substr, analytic):
        """Shared rotary nn.Parameters may survive under any alias; fall
        back to the analytic table if none does."""
        if canonical in state:
            return take(canonical)
        for k in sorted(state):
            if alias_substr in k:
                used.add(k)
                return _f32(state[k])
        return analytic

    def lin(base, bias=True):
        node = {"kernel": take(f"{base}.weight", _t)}
        if bias:
            node["bias"] = take(f"{base}.bias")
        return node

    params = {
        "patch_embed": {"kernel": take("x_embedder.proj.weight",
                                       _conv_kernel),
                        "bias": take("x_embedder.proj.bias")},
        "t_embedder": {"fc1": lin("t_embedder.mlp.0"),
                       "fc2": lin("t_embedder.mlp.2")},
        "spatial_rope_freqs": take_rope(
            "spatial_rotary_emb.freqs", "s_attn.rotary_emb.freqs",
            rope.pixel_freqs(cfg.head_dim // 2, max_freq=256.0)),
        "temporal_rope_freqs": take_rope(
            "temporal_rotary_emb.freqs", "t_attn.rotary_emb.freqs",
            rope.lang_freqs(cfg.head_dim)),
        "final": {"adaln": lin("final_layer.adaLN_modulation.1"),
                  "linear": lin("final_layer.linear")},
    }
    if cfg.external_cond_dim > 0:
        if "external_cond.weight" in state:
            params["external_cond"] = lin("external_cond")
        else:
            missing.extend(["external_cond.weight", "external_cond.bias"])
    blocks = []
    for i in range(cfg.depth):
        bp: dict = {}
        for path, (suffix, has_bias) in _DIT_BLOCK_LIN.items():
            _set(bp, path, lin(f"blocks.{i}.{suffix}", has_bias))
        blocks.append(bp)
    params["blocks"] = blocks
    return params, missing, sorted(set(state) - used)


# ----------------------------------------------------------------- VAE

_VAE_TOP = {
    ("patch_embed",): ("patch_embed.proj", "conv"),
    ("enc_norm",): ("enc_norm", "ln"),
    ("quant",): ("quant_conv", "lin"),
    ("post_quant",): ("post_quant_conv", "lin"),
    ("dec_norm",): ("dec_norm", "ln"),
    ("predictor",): ("predictor", "lin"),
}

_VAE_BLOCK = {
    ("norm1",): ("norm1", "ln"),
    ("attn", "qkv"): ("attn.qkv", "lin"),
    ("attn", "out"): ("attn.proj", "lin"),
    ("norm2",): ("norm2", "ln"),
    ("mlp", "fc1"): ("mlp.fc1", "lin"),
    ("mlp", "fc2"): ("mlp.fc2", "lin"),
}


def vae_from_torch(state: dict, cfg):
    """Port VAE params from a torch state_dict -> (params, missing,
    unexpected)."""
    used: set[str] = set()
    missing: list[str] = []

    def take(key, fn=_f32):
        if key not in state:
            missing.append(key)
            return None
        used.add(key)
        return fn(state[key])

    def node_for(base, kind):
        if kind == "conv":
            return {"kernel": take(f"{base}.weight", _conv_kernel),
                    "bias": take(f"{base}.bias")}
        if kind == "lin":
            return {"kernel": take(f"{base}.weight", _t),
                    "bias": take(f"{base}.bias")}
        return {"weight": take(f"{base}.weight"),
                "bias": take(f"{base}.bias")}

    params: dict = {}
    for path, (base, kind) in _VAE_TOP.items():
        _set(params, path, node_for(base, kind))
    for name, depth in (("encoder", cfg.enc_depth),
                        ("decoder", cfg.dec_depth)):
        blocks = []
        for i in range(depth):
            bp: dict = {}
            for path, (suffix, kind) in _VAE_BLOCK.items():
                _set(bp, path, node_for(f"{name}.{i}.{suffix}", kind))
            blocks.append(bp)
        params[name] = blocks
    return params, missing, sorted(set(state) - used)


def load_dit(path: str, cfg, verbose: bool = True):
    params, missing, unexpected = dit_from_torch(
        strip_prefix(read_safetensors(path)), cfg)
    if verbose and (missing or unexpected):
        print(f"[gtax_torch] DiT checkpoint '{path}' key diff — missing: "
              f"{missing}\nunexpected: {unexpected}")
    return params


def load_vae(path: str, cfg, verbose: bool = True):
    params, missing, unexpected = vae_from_torch(
        strip_prefix(read_safetensors(path)), cfg)
    if verbose and (missing or unexpected):
        print(f"[gtax_torch] VAE checkpoint '{path}' key diff — missing: "
              f"{missing}\nunexpected: {unexpected}")
    return params


# --------------------------------------------------------- weight bridge

def _tree_to_torch(tree):
    """Float leaves -> fp32 tensors; integer leaves (W8A8 "kernel_q") keep
    their dtype."""
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.copy())
    return _f32(tree)


def _unstack(blocks):
    """Stacked block dict (leading depth axis on every leaf) -> list of
    per-block dicts; a list/tuple passes through."""
    if isinstance(blocks, (list, tuple)):
        return [_tree_to_torch(b) for b in blocks]
    stacked = _tree_to_torch(blocks)

    def first_leaf(t):
        return t if isinstance(t, torch.Tensor) else first_leaf(
            next(iter(t.values())))

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i].contiguous()

    return [pick(stacked, i) for i in range(first_leaf(stacked).shape[0])]


def dit_from_gtax(tree: dict):
    """gtax DiT params (nested dicts of numpy arrays) -> port params."""
    params = {k: _tree_to_torch(v) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = _unstack(tree["blocks"])
    return params


def vae_from_gtax(tree: dict):
    """gtax VAE params (nested dicts of numpy arrays) -> port params."""
    params = {k: _tree_to_torch(v) for k, v in tree.items()
              if k not in ("encoder", "decoder")}
    params["encoder"] = _unstack(tree["encoder"])
    params["decoder"] = _unstack(tree["decoder"])
    return params
