"""Reference checkpoints and gtax parameter trees -> the port's parameters
(counterpart of gtax/io/safetensors_port.py).

The safetensors format is read and written directly (the card's machine
has no `safetensors` package): an 8-byte little-endian header length, a
JSON header of {name: {dtype, shape, data_offsets}} padded with spaces to
8 bytes, then the raw buffers, back to back. Both directions go one tensor
at a time, so a file is never held in host memory whole.
`iter_safetensors` keeps every dtype (the trainer's checkpoints need their
bf16 moments back as bf16); `read_safetensors` upcasts bf16 to float32,
like gtax's reader, for the weight loaders.

Layout mappings (torch state_dict -> port), as in gtax:
  - nn.Linear weight (out, in)              -> kernel (in, out)
  - patch-embed Conv2d weight (D, C, p, p)  -> kernel (C*p*p, D)
  - per-block tensors blocks.{i}.X          -> blocks[i]
  - rotary freqs nn.Parameters              -> {spatial,temporal}_rope_freqs

The writers (`dit_to_torch`, `vae_to_torch`, `save_dit`, `save_vae`) are
the inverse mappings: the port's tree (per-block list) -> the reference's
fp32 state_dict, restacked under blocks.{i}; gtax's `read_safetensors`,
the reference and this module read the file.

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


_NAMES = {v: k for k, v in _DTYPES.items()}


def iter_safetensors(path: str):
    """(name, CPU tensor) pairs of a safetensors file in file order, every
    dtype kept; each tensor is read into its own buffer, one at a time."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        start = 8 + n
        header.pop("__metadata__", None)
        for name, info in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = info["data_offsets"]
            raw = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(start + begin)
            if f.readinto(memoryview(raw.numpy())) != end - begin:
                raise ValueError(f"{path}: {name} is truncated")
            yield name, raw.view(_DTYPES[info["dtype"]]).reshape(
                info["shape"])


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors (bf16 upcast to fp32)."""
    return {name: t.float() if t.dtype == torch.bfloat16 else t
            for name, t in iter_safetensors(path)}


def write_safetensors(path: str, tensors: dict) -> None:
    """Write {name: tensor or numpy array} (any device) as safetensors, in
    the dict's order; each tensor is copied to the host as it is written."""
    items = [(k, torch.from_numpy(np.ascontiguousarray(v))
              if isinstance(v, np.ndarray) else v.detach())
             for k, v in tensors.items()]
    header, off = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8)
                    .numpy().data)


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


# ------------------------------------------------------------- writers

def _block_node(blocks, i, path):
    """Block i's node at `path` (blocks: the port's list of per-block
    dicts, or a stacked dict of (depth, ...) leaves, read as block i's
    views)."""
    stacked = isinstance(blocks, dict)
    node = blocks if stacked else blocks[i]
    for p in path:
        node = node[p]
    return {k: v[i] for k, v in node.items()} if stacked else node


def _host32(x) -> torch.Tensor:
    return _f32(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def dit_to_torch(params, cfg) -> dict[str, torch.Tensor]:
    """Port DiT params -> the reference's torch state_dict (fp32 CPU
    tensors): kernels transposed back to (out, in), the patch-embed kernel
    reshaped to its Conv2d weight, block i's leaves under blocks.{i}."""
    out: dict[str, torch.Tensor] = {}

    def put(key, x):
        out[key] = _host32(x).contiguous()

    def lin(key, node, bias=True):
        put(f"{key}.weight", _host32(node["kernel"]).T)
        if bias:
            put(f"{key}.bias", node["bias"])

    D, p = cfg.hidden_size, cfg.patch_size
    put("x_embedder.proj.weight", _host32(params["patch_embed"]["kernel"])
        .T.reshape(D, cfg.in_channels, p, p))
    put("x_embedder.proj.bias", params["patch_embed"]["bias"])
    lin("t_embedder.mlp.0", params["t_embedder"]["fc1"])
    lin("t_embedder.mlp.2", params["t_embedder"]["fc2"])
    put("spatial_rotary_emb.freqs", params["spatial_rope_freqs"])
    put("temporal_rotary_emb.freqs", params["temporal_rope_freqs"])
    if "external_cond" in params:
        lin("external_cond", params["external_cond"])
    lin("final_layer.adaLN_modulation.1", params["final"]["adaln"])
    lin("final_layer.linear", params["final"]["linear"])
    for path, (suffix, has_bias) in _DIT_BLOCK_LIN.items():
        for i in range(cfg.depth):
            lin(f"blocks.{i}.{suffix}", _block_node(params["blocks"], i,
                                                    path), has_bias)
    return out


def vae_to_torch(params, cfg) -> dict[str, torch.Tensor]:
    """Port VAE params -> the reference's torch state_dict (fp32 CPU)."""
    out: dict[str, torch.Tensor] = {}

    def emit(base, kind, node):
        if kind == "conv":
            k = _host32(node["kernel"]).T
            out[f"{base}.weight"] = k.reshape(
                k.shape[0], 3, cfg.patch_size, cfg.patch_size).contiguous()
        elif kind == "lin":
            out[f"{base}.weight"] = _host32(node["kernel"]).T.contiguous()
        else:
            out[f"{base}.weight"] = _host32(node["weight"])
        out[f"{base}.bias"] = _host32(node["bias"])

    for path, (base, kind) in _VAE_TOP.items():
        node = params
        for p in path:
            node = node[p]
        emit(base, kind, node)
    for name, depth in (("encoder", cfg.enc_depth),
                        ("decoder", cfg.dec_depth)):
        for path, (suffix, kind) in _VAE_BLOCK.items():
            for i in range(depth):
                emit(f"{name}.{i}.{suffix}", kind,
                     _block_node(params[name], i, path))
    return out


def save_dit(path: str, params, cfg) -> None:
    write_safetensors(path, dit_to_torch(params, cfg))


def save_vae(path: str, params, cfg) -> None:
    write_safetensors(path, vae_to_torch(params, cfg))


def expected_dit_keys(cfg) -> set[str]:
    """The reference DiT's state_dict key set."""
    keys = {"x_embedder.proj.weight", "x_embedder.proj.bias",
            "t_embedder.mlp.0.weight", "t_embedder.mlp.0.bias",
            "t_embedder.mlp.2.weight", "t_embedder.mlp.2.bias",
            "spatial_rotary_emb.freqs", "temporal_rotary_emb.freqs",
            "final_layer.adaLN_modulation.1.weight",
            "final_layer.adaLN_modulation.1.bias",
            "final_layer.linear.weight", "final_layer.linear.bias"}
    if cfg.external_cond_dim > 0:
        keys |= {"external_cond.weight", "external_cond.bias"}
    for i in range(cfg.depth):
        for suffix, has_bias in _DIT_BLOCK_LIN.values():
            keys.add(f"blocks.{i}.{suffix}.weight")
            if has_bias:
                keys.add(f"blocks.{i}.{suffix}.bias")
    return keys


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
