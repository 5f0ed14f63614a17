"""Process groups, the (data, model) layout and the tensor-parallel
sharding rules (counterpart of gtax/parallel/mesh.py), over
torch.distributed with one process per card, as `torchrun` launches them.

gtax's only parallelism in the reference is DDP training over NCCL; gtax
puts its devices on a (data, model) mesh and lets XLA insert the
collectives. Here each process is one position of that layout: rank =
data index * model + model index, as gtax reshapes its device list
(data, model). The collectives are explicit:

  data  -- the batch's rows. Training sums the gradients over this axis
           (one all-reduce a step, gtax's psum); batched serving runs one
           whole single-card rollout a rank over its own rows.
  model -- tensor parallelism of the DiT blocks: each rank holds its
           heads of qkv and its columns of fc1 and of the adaLN heads
           (_dit_param_spec). Under the `xla` backend it attends over its
           heads, and the out-projection's and fc2's partial products are
           summed by an all-reduce before their replicated biases; under
           the fused backends each block's cut leaves are gathered whole
           in front of the kernels (gtax_torch.models.dit). The
           collectives are autograd Functions (Axis.reduce_sum, copy_in,
           gather), so the same forward trains.

initialize_distributed() joins the group (NCCL on the card, gloo on the
CPU) from explicit arguments, gtax's GTAX_* environment or torchrun's; in
one process it does nothing, and every function here then sees a world of
one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining processes
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        """(data, model) over n_devices processes (gtax's rule; a layout
        that does not fill them raises ValueError)."""
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices: "
                             "launch one process a card, data x model of "
                             "them (torchrun --nproc_per_node N)")
        return data, model


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(process_id: int | None = None) -> int:
    """This process's card on its host: LOCAL_RANK (torchrun sets it), else
    the process id modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    pid = process_index() if process_id is None else process_id
    return pid % max(1, torch.cuda.device_count())


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device=None,
                           timeout_s=None) -> bool:
    """Join the process group; returns whether this process is in one.
    Three modes, as gtax's:

    - explicit arguments (tests, manual clusters); the address is
      "host:port" or an init_method URL ("tcp://...", "file://...");
    - gtax's environment: GTAX_COORDINATOR / GTAX_NUM_PROCESSES /
      GTAX_PROCESS_ID;
    - torchrun's: RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (and
      LOCAL_RANK), in place of gtax's TPU-pod auto-detect.

    A no-op in one process, and when the group exists already. The backend
    is NCCL when the process runs on a card (`device`, default: a card when
    there is one) and gloo on the CPU; `backend` names another (the
    smoke's ranks that share one card take gloo, which NCCL refuses). On a
    card, the rank's device is set to cuda:LOCAL_RANK first."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None:
        if "GTAX_NUM_PROCESSES" in env:
            num_processes = int(env["GTAX_NUM_PROCESSES"])
            coordinator_address = env.get("GTAX_COORDINATOR")
            process_id = int(env["GTAX_PROCESS_ID"])
        elif "WORLD_SIZE" in env and "RANK" in env:
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env["RANK"])
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and this process's id")
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if on_card:
        torch.cuda.set_device(local_rank(process_id))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"),
                            init_method=init, world_size=num_processes,
                            rank=process_id, **kw)
    return True


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it, and the group of the ranks along it; None where there
    is nothing to reduce (an axis of one rank inside a larger world, or a
    process outside any group). An axis that spans a world of one keeps
    its group: its collectives run, and are the identity."""
    size: int
    index: int
    group: object = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over the axis, in place; returns t."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def gather_objects(self, obj) -> list:
        """Every rank's picklable obj, in index order."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = -1,
                   qkv: bool = False) -> torch.Tensor:
        """The axis's t joined along `dim`, in index order; qkv: each
        rank's t is its thirds of q, k and v (shard_params' qkv cut), and
        the result is q | k | v whole. No autograd (`gather` has it)."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        if not qkv:
            return torch.cat(parts, dim=dim)
        thirds = [p.chunk(3, dim) for p in parts]
        return torch.cat([torch.cat([p[j] for p in thirds], dim)
                          for j in range(3)], dim)

    # the differentiable collectives of tensor parallelism (Megatron's
    # conjugate pairs): each is the identity without a group

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' t (a row-cut product's partial sums); the
        backward passes the gradient through: every rank's output is the
        same, and so is its gradient."""
        return t if self.group is None else _ReduceSum.apply(t, self)

    def copy_in(self, t: torch.Tensor) -> torch.Tensor:
        """t itself, where replicated rows enter a column-cut product; the
        backward sums the ranks' gradients (each rank's columns give a
        part of the rows' gradient)."""
        return t if self.group is None else _CopyIn.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int = -1,
               qkv: bool = False) -> torch.Tensor:
        """all_gather with a gradient: the backward keeps this rank's slice
        of the whole tensor's gradient (every rank computes the same one
        downstream)."""
        if self.group is None:
            return t
        return _Gather.apply(t, self, dim, qkv)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        out = t.clone(memory_format=torch.contiguous_format)
        return axis.all_reduce(out)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(
            grad.clone(memory_format=torch.contiguous_format)), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, qkv):
        ctx.axis, ctx.dim, ctx.qkv = axis, dim % t.dim(), qkv
        return axis.all_gather(t, dim, qkv)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        return (_shard(grad, ctx.dim, ctx.qkv, a.size, a.index), None, None,
                None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) layout of the process group: `shape` as gtax's
    mesh.shape, and this rank's Axis along each."""
    data: Axis
    model: Axis

    @property
    def shape(self) -> dict:
        return {"data": self.data.size, "model": self.model.size}

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Global rank 0's t on every rank of the group, in place; returns
        t (nothing to do in one process)."""
        if dist.is_initialized():
            dist.broadcast(t, src=0)
        return t

    def barrier(self) -> None:
        """Every rank of the group waits for the others."""
        if dist.is_initialized():
            dist.barrier()


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The group's (data, model) layout (ranks row-major, as gtax reshapes
    its devices), with a subgroup for each axis that spans part of the
    world. Collective: every rank calls it, with the same cfg. In one
    process: a 1x1 mesh."""
    cfg = cfg or MeshConfig()
    n = world_size()
    data, model = cfg.resolve(n)
    rank = process_index()
    d, m = divmod(rank, model)

    def axis(size, index, rank_lists):
        if size == n:  # the whole world (None outside a group)
            return Axis(size, index, dist.group.WORLD
                        if dist.is_initialized() else None)
        if size == 1:
            return Axis(size, index)
        group, _ = dist.new_subgroups_by_enumeration(rank_lists)
        return Axis(size, index, group)

    return Mesh(
        data=axis(data, d, [[i * model + j for i in range(data)]
                            for j in range(model)]),
        model=axis(model, m, [[i * model + j for j in range(model)]
                              for i in range(data)]))


def process_batch_slice(global_batch: int, data: Axis | None = None) -> slice:
    """The half-open range of the global batch owned by this process: its
    data index's rows of `data` (a mesh's data axis: the model ranks of a
    data index share its rows), or of the whole world without one."""
    n, i = ((world_size(), process_index()) if data is None
            else (data.size, data.index))
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def data_position(cfg: MeshConfig) -> tuple[int, int]:
    """(data index, data size) of this process under cfg, without making
    the groups (the loaders are built before the trainer's mesh): rank =
    data index * model + model index."""
    data, model = cfg.resolve(world_size())
    return process_index() // model, data


def rank_seed(seed: int, index: int) -> int:
    """The seed of data index `index`'s stream, derived from (seed, index)
    by numpy's SeedSequence (a fixed hash, the same on every platform and
    Python; a negative seed is taken modulo 2**64): the counterpart of gtax's fold_in(rng, axis_index("data"));
    index 0 included, every index draws its own noise."""
    return int(np.random.SeedSequence([seed % 2**64, index]).generate_state(
        1, np.uint64)[0])


# ------------------------------------------------------- sharding rules

def _dit_param_spec(path: tuple, ndim: int) -> tuple:
    """gtax's tensor-parallel rules for a DiT leaf at `path` (its keys;
    list indices are ignored): one entry a dim, "model" where the leaf is
    cut over the model axis, () for a replicated leaf.

    Stacked block kernels are (L, in, out): qkv / fc1 / the adaLN heads cut
    on the output dim, out / fc2 on the input dim, so a block needs one sum
    over the axis a pair; the unstacked layout cuts the same dims one rank
    lower; the column products' biases go with their columns, the row
    products' stay whole."""
    names = set(path)
    if "blocks" not in names:
        return ()
    col = {"qkv", "fc1", "s_adaln", "t_adaln", "adaln"}
    row = {"out", "fc2"}
    if "kernel" in names:
        if ndim == 3:
            if names & col:
                return (None, None, "model")
            if names & row:
                return (None, "model", None)
        if ndim == 2:
            if names & col:
                return (None, "model")
            if names & row:
                return ("model", None)
    if "bias" in names and names & col:
        if ndim == 2:
            return (None, "model")
        if ndim == 1:
            return ("model",)
    return ()


def _shard(leaf: torch.Tensor, dim: int, qkv: bool, size: int,
           index: int) -> torch.Tensor:
    if qkv:  # this rank's heads of each of q, k and v (contiguous thirds)
        return torch.cat([t.chunk(size, dim)[index]
                          for t in leaf.chunk(3, dim)], dim)
    return leaf.chunk(size, dim)[index].clone(
        memory_format=torch.contiguous_format)


def spec_dim(path: tuple, ndim: int, rules=_dit_param_spec) -> int | None:
    """The dim `rules` cut over the model axis for a leaf at `path` of
    `ndim` dims (whole or a shard), or None for a replicated leaf."""
    spec = rules(path, ndim)
    return spec.index("model") if "model" in spec else None


def cut_dim(path: tuple, leaf: torch.Tensor, size: int,
            rules=_dit_param_spec) -> int | None:
    """The dim of `leaf` that `rules` cut over `size` model ranks, or None
    for a replicated leaf (or size 1). A cut that does not divide raises
    ValueError."""
    dim = spec_dim(path, leaf.dim(), rules)
    if size == 1 or dim is None:
        return None
    if leaf.shape[dim] % size:
        raise ValueError(f"{'/'.join(map(str, path))}: dim {dim} of "
                         f"{tuple(leaf.shape)} does not divide over "
                         f"{size} ranks")
    return dim


def cut_leaf(path: tuple, leaf: torch.Tensor, axis: Axis,
             rules=_dit_param_spec) -> torch.Tensor:
    """This rank's shard of a whole leaf at `path` (the leaf itself when
    it is replicated)."""
    dim = cut_dim(path, leaf, axis.size, rules)
    if dim is None:
        return leaf
    return _shard(leaf, dim, "qkv" in path, axis.size, axis.index)


def _walk(node, fn, path=()):
    if isinstance(node, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(node)]
    return fn(path, node)


def gather_leaf(path: tuple, leaf: torch.Tensor, axis: Axis,
                rules=_dit_param_spec) -> torch.Tensor:
    """The whole leaf at `path` from this rank's shard (collective over
    the axis; the shard itself when the leaf is replicated); no
    autograd."""
    dim = spec_dim(path, leaf.dim(), rules)
    if axis.size == 1 or dim is None:
        return leaf
    with torch.no_grad():
        return axis.all_gather(leaf, dim, "qkv" in path)


def gather_params(params, mesh: Mesh, rules=_dit_param_spec):
    """The inverse of shard_params: every cut leaf gathered whole over the
    model axis (collective: every rank of the axis calls it), replicated
    leaves as they are; no autograd. With model = 1 the tree itself."""
    if mesh.model.size == 1:
        return params
    return _walk(params, lambda path, leaf: gather_leaf(path, leaf,
                                                        mesh.model, rules))


def key_path(key: str) -> tuple:
    """A "/"-joined tree path (checkpoint keys) as a path tuple."""
    return tuple(int(p) if p.isdigit() else p for p in key.split("/"))


def shard_params(params, mesh: Mesh, rules=_dit_param_spec):
    """Each leaf of a DiT param tree (either layout) cut to this rank's
    shard along the dim that `rules` give "model" (gtax's param_sharding,
    where GSPMD lays the leaves out). qkv's columns are this rank's heads
    of each of q, k and v, so each rank attends over H / model whole
    heads; the adaLN heads' 6D columns are contiguous blocks, which an
    all-gather in rank order joins again. With model = 1 the tree is
    returned as it is, replicated."""
    if mesh.model.size == 1:
        return params
    return _walk(params, lambda path, leaf: cut_leaf(path, leaf, mesh.model,
                                                     rules))


def data_parallel_rollout(rollout, mesh: Mesh, num_gen_frames: int):
    """Batched serving over the data axis: wrapped(params, latents,
    actions, seed) runs one whole single-card rollout over this rank's
    rows (the caller's slice, process_batch_slice, of the global batch)
    with a generator of its own, seeded rank_seed(seed, data index) on the
    rows' device, and returns this rank's rows: each rank writes its own
    videos, as gtax's multi-process contract gives them
    (gtax/serving.py:370-374, 428-436)."""

    def wrapped(params, latents, actions, seed: int):
        gen = torch.Generator(device=latents.device).manual_seed(
            rank_seed(seed, mesh.data.index))
        return rollout(params, latents, actions, gen,
                       num_gen_frames=num_gen_frames)

    return wrapped


def all_reduce_grads(grads, axis: Axis):
    """Sum every tensor of `grads` over the axis (the trainer's: the data
    axis, for the cut and the replicated leaves alike), in place: one
    all-reduce a leaf, with no copy. Nothing to do without a group."""
    for g in grads:
        axis.all_reduce(g)
