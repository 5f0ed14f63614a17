"""The trainer's full state on disk: the port's own format in place of
gtax's orbax train state (gtax/train/trainer.py:763-862), under gtax's
paths, so tools and users find the same files:

    <output_dir>/train_checkpoints/<model_name>_last/
        step.json                       step, epoch, time, wandb_run_id,
                                        data_cursor (written after the state)
        state_<step>/state.safetensors  params/<path> (fp32 masters),
                                        mu/<path> (its own dtype: bf16 under
                                        mu_bf16), nu/<path>, generator
        state_<step>/state.json         global_step, count, generator
                                        device, the params' layout

Tensors are keyed by their tree path ("blocks/3/s_attn/qkv/kernel") and
written and read one at a time by the port's safetensors code, every dtype
kept; nothing is pickled. A state directory is written under a temporary
name and renamed when complete, step.json is replaced atomically after it,
and superseded state_* directories are pruned only then, so step.json
always names a complete state.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from gtax_torch.io.safetensors_port import iter_safetensors, write_safetensors
from gtax_torch.train.optim import leaves

STATE = "state.safetensors"
META = "state.json"
STEP = "step.json"


def ckpt_dir(output_dir: str, model_name: str) -> str:
    return os.path.abspath(os.path.join(
        output_dir, "train_checkpoints", f"{model_name}_last"))


def flat(tree) -> dict[str, torch.Tensor]:
    """{"/"-joined tree path: leaf} of a nested dict/list of tensors."""
    return {"/".join(map(str, path)): leaf for path, leaf in leaves(tree)}


def unflatten(items) -> dict:
    """Inverse of `flat` over (key, tensor) pairs: a node whose keys are
    all digits becomes a list."""
    root: dict = {}
    for key, t in items:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def write_json(path: str, obj) -> None:
    """Write JSON through a temporary file and an atomic rename."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def write_state(state_dir: str, params, optimizer, generator,
                global_step: int, layout: str = "unstacked") -> int:
    """Write params, the optimizer's moments and count (an optimizer, or
    its state_dict: a tensor-parallel trainer passes the whole moments),
    the generator's state, global_step and the params' layout
    ("unstacked" or "stacked") into state_dir; returns the bytes
    written."""
    tmp = state_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    opt = optimizer if isinstance(optimizer, dict) else (
        optimizer.state_dict())
    tensors = {f"params/{k}": v for k, v in flat(params).items()}
    for name in ("mu", "nu"):
        tensors.update({f"{name}/{k}": v for k, v in opt[name].items()})
    tensors["generator"] = generator.get_state()
    write_safetensors(os.path.join(tmp, STATE), tensors)
    write_json(os.path.join(tmp, META), {
        "global_step": global_step, "count": opt["count"],
        "generator_device": generator.device.type, "layout": layout})
    shutil.rmtree(state_dir, ignore_errors=True)
    os.rename(tmp, state_dir)
    return sum(os.path.getsize(os.path.join(state_dir, f))
               for f in (STATE, META))


@torch.no_grad()
def read_state(state_dir: str, params, optimizer, generator,
               layout: str = "unstacked", cut=None) -> dict:
    """Load a write_state directory: each master is copied in place (the
    optimizer holds references to them), the moments and count go through
    optimizer.load_state_dict, the generator takes its saved state.
    cut(key, tensor): the part of each whole master and moment this
    process holds (a tensor-parallel trainer's shard), applied before the
    copy. Returns state.json's contents. A state of the other layout
    (states without one are unstacked) or a missing, extra or mis-shaped
    tensor raises."""
    with open(os.path.join(state_dir, META)) as f:
        meta = json.load(f)
    saved = meta.get("layout", "unstacked")
    if saved != layout:  # gtax's orbax state needs the same setting too
        raise ValueError(
            f"{state_dir} holds {saved} params; this trainer's are {layout} "
            f"(unstack_train: {str(layout == 'unstacked').lower()}): resume "
            f"with unstack_train: {str(saved == 'unstacked').lower()}")
    if meta["generator_device"] != generator.device.type:
        raise ValueError(
            f"{state_dir} holds a {meta['generator_device']} generator; "
            f"this trainer runs on {generator.device.type}")
    masters = flat(params)
    moments: dict = {"mu": {}, "nu": {}}
    seen = set()
    for name, t in iter_safetensors(os.path.join(state_dir, STATE)):
        kind, _, key = name.partition("/")
        seen.add(name)
        if cut is not None and kind in ("params", "mu", "nu"):
            t = cut(key, t)
        if kind == "params":
            dst = masters.get(key)
            if dst is None or dst.shape != t.shape or dst.dtype != t.dtype:
                raise ValueError(f"{state_dir}: {name} does not match the "
                                 "trainer's params")
            dst.copy_(t)
        elif kind in moments:
            moments[kind][key] = t
        elif name == "generator":
            generator.set_state(t)
        else:
            raise ValueError(f"{state_dir}: unexpected tensor {name}")
    missing = {f"params/{k}" for k in masters} - seen
    if missing or "generator" not in seen:
        raise ValueError(f"{state_dir}: missing {sorted(missing)[:5]}"
                         + ("" if "generator" in seen else " and generator"))
    optimizer.load_state_dict({"count": meta["count"], **moments})
    return meta


def read_params(state_dir: str) -> dict:
    """The fp32 masters of a write_state directory as a param tree."""
    return unflatten((name[len("params/"):], t) for name, t in
                     iter_safetensors(os.path.join(state_dir, STATE))
                     if name.startswith("params/"))


def prune(path: str, keep: str) -> None:
    """Remove every state_* entry of `path` but `keep`."""
    for name in os.listdir(path):
        if name.startswith("state_") and name != keep:
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)


def resolve_state_dir(path: str, step: int | None = None) -> str:
    """A state_<N> directory from `path`: itself if it is one, else
    <path>/state_<step>, the step from --step or <path>/step.json (gtax
    cli/export.py's rules)."""
    path = os.path.abspath(path)
    if os.path.basename(path).startswith("state_"):
        return path
    if step is None:
        meta = os.path.join(path, STEP)
        if not os.path.exists(meta):
            raise FileNotFoundError(
                f"{path} has no {STEP}; pass a state_<N> dir or --step")
        with open(meta) as f:
            step = json.load(f)["step"]
    state_dir = os.path.join(path, f"state_{step}")
    if not os.path.isdir(state_dir):
        raise FileNotFoundError(f"missing {state_dir}")
    return state_dir
