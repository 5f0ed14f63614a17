"""gtax_torch.parallel.mesh in one process, against gtax/parallel/mesh.py:
the tensor-parallel rules on every leaf of the flagship DiT-S/2 in both
layouts (gtax's shapes from jax.eval_shape), MeshConfig.resolve, the
shards of shard_params joined back per head, initialize_distributed's
three modes (the group's constructor recorded, not called) and its no-op,
the one-process identities of the mesh, the data-parallel draws, and what
the port refuses as gtax does. tests/test_torch_multiproc.py runs the
collectives over two processes.
"""

import jax
import pytest
import torch

from gtax.models import dit as jdit
from gtax.parallel import mesh as jmesh
from gtax_torch import serving
from gtax_torch.models import dit as tdit
from gtax_torch.parallel import mesh
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.trainer import check_slice

torch.set_num_threads(2)

# the leaves a block cuts: both adaLN heads' kernel and bias, both
# attentions' qkv and out kernels, both MLPs' fc1 kernel and bias and fc2
# kernel (the out and fc2 biases stay whole)
CUT_PER_BLOCK = 4 + 4 + 6


def _path(keys):
    """A jax tree path as the port's: dict keys, list indices as ints."""
    return tuple(k.key if hasattr(k, "key") else k.idx for k in keys)


def _flagship_shapes(layout):
    cfg = jdit.DiT_MODELS["DiT-S/2"]()
    shapes = jax.eval_shape(lambda k: jdit.dit_init(k, cfg),
                            jax.random.PRNGKey(0))
    if layout == "unstacked":
        shapes = jax.eval_shape(
            lambda p: jdit.unstack_for_inference(p, cfg), shapes)
    return jax.tree_util.tree_flatten_with_path(shapes)[0]


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_param_spec_matches_gtax(layout):
    """The port's rule equals gtax's on every leaf of DiT-S/2, and every
    dim it cuts divides by 8 (gtax's v5e-8 promise,
    tests/test_serving_tp.py)."""
    leaves = _flagship_shapes(layout)
    cut = 0
    for keys, leaf in leaves:
        gtax_keys = tuple(k.key if hasattr(k, "key") else str(k)
                          for k in keys)
        want = tuple(jmesh._dit_param_spec(gtax_keys, leaf.ndim))
        got = mesh._dit_param_spec(_path(keys), leaf.ndim)
        assert got == want, gtax_keys
        if "model" in got:
            cut += 1
            assert leaf.shape[got.index("model")] % 8 == 0, gtax_keys
    assert cut == CUT_PER_BLOCK * (1 if layout == "stacked" else 16)


@pytest.mark.parametrize("data", [-1, 1, 2, 4])
@pytest.mark.parametrize("model", [0, 1, 2, 4])
def test_mesh_config_resolve_matches_gtax(data, model):
    for n in (1, 2, 4, 8):
        try:
            want = jmesh.MeshConfig(data, model).resolve(n)
        except AssertionError:
            with pytest.raises(ValueError, match="mesh"):
                mesh.MeshConfig(data, model).resolve(n)
        else:
            assert mesh.MeshConfig(data, model).resolve(n) == want


SMALL = tdit.DiTConfig(input_h=4, input_w=4, in_channels=4, hidden_size=64,
                       depth=2, num_heads=4, max_frames=3)


def _small_params(stacked):
    gen = torch.Generator().manual_seed(0)
    p = tdit._map_params(tdit.dit_init(SMALL, gen),
                         lambda _, a: torch.randn(a.shape, generator=gen))
    return tdit.restack_params(p, SMALL) if stacked else p


def _rank_mesh(size, index):
    return mesh.Mesh(data=mesh.Axis(1, 0), model=mesh.Axis(size, index))


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["unstacked", "stacked"])
@pytest.mark.parametrize("size", [2, 4])
def test_shard_params_join_back_per_head(stacked, size):
    """Each rank's shards, joined in rank order (qkv per third: its heads
    of q, k and v), give back every leaf; the rest stays whole."""
    full = _small_params(stacked)
    shards = [mesh.shard_params(full, _rank_mesh(size, r))
              for r in range(size)]
    n_cut = 0
    for path, leaf in tdit_leaves(full):
        parts = [dict(tdit_leaves(s))[path] for s in shards]
        spec = mesh._dit_param_spec(path, leaf.dim())
        if "model" not in spec:
            assert all(p is leaf for p in parts)
            continue
        n_cut += 1
        dim = spec.index("model")
        assert all(p.shape[dim] * size == leaf.shape[dim] for p in parts)
        if "qkv" in path:
            thirds = [torch.cat([p.chunk(3, dim)[j] for p in parts], dim)
                      for j in range(3)]
            joined = torch.cat(thirds, dim)
            # rank r holds heads r*H/size .. of q: columns of whole heads
            head = SMALL.head_dim * SMALL.num_heads // size
            assert torch.equal(parts[1].chunk(3, dim)[0],
                               leaf.narrow(dim, head, head))
        else:
            joined = torch.cat(parts, dim)
        assert torch.equal(joined, leaf), path
    assert n_cut == CUT_PER_BLOCK * (1 if stacked else SMALL.depth)


def tdit_leaves(params):
    out = []
    tdit._map_params(params, lambda path, a: out.append((path, a)))
    return out


def test_shard_params_one_model_rank_is_the_tree():
    full = _small_params(False)
    assert mesh.shard_params(full, _rank_mesh(1, 0)) is full


def test_shard_params_refuses_an_uneven_cut():
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_params(_small_params(False), _rank_mesh(3, 0))


# ------------------------------------------------- initialize_distributed

ENV = ("GTAX_COORDINATOR", "GTAX_NUM_PROCESSES", "GTAX_PROCESS_ID", "RANK",
       "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def recorded(monkeypatch):
    """init_process_group's calls, recorded instead of made, in a clean
    environment."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


@pytest.mark.parametrize("mode,env,args,want", [
    ("gtax_env", {"GTAX_COORDINATOR": "host:1234", "GTAX_NUM_PROCESSES": "2",
                  "GTAX_PROCESS_ID": "1"}, {}, ("tcp://host:1234", 2, 1)),
    ("torchrun_env", {"RANK": "3", "WORLD_SIZE": "4", "MASTER_ADDR": "h",
                      "MASTER_PORT": "29500", "LOCAL_RANK": "1"}, {},
     ("tcp://h:29500", 4, 3)),
    ("explicit", {}, {"coordinator_address": "file:///tmp/s",
                      "num_processes": 2, "process_id": 0},
     ("file:///tmp/s", 2, 0)),
])
def test_initialize_distributed_modes(recorded, monkeypatch, mode, env,
                                      args, want):
    """Each mode hands the group its address, size and rank; gloo on the
    CPU."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh.initialize_distributed(device="cpu", timeout_s=5, **args)
    (a, kw), = recorded
    assert a == ("gloo",)
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == want
    assert kw["timeout"].total_seconds() == 5


@pytest.mark.parametrize("env", [{}, {"GTAX_NUM_PROCESSES": "1",
                                      "GTAX_PROCESS_ID": "0"},
                                 {"RANK": "0", "WORLD_SIZE": "1",
                                  "MASTER_ADDR": "h", "MASTER_PORT": "1"}])
def test_initialize_distributed_one_process_is_a_no_op(recorded,
                                                        monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert not mesh.initialize_distributed()
    assert recorded == []


def test_one_process_mesh_is_the_identity():
    """Outside a group: a 1x1 mesh whose collectives return their input,
    the whole batch, and per-index seeds that differ."""
    m = mesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    t = torch.arange(6.0)
    for axis in (m.data, m.model):
        assert axis.group is None
        assert axis.all_reduce(t) is t and axis.all_gather(t) is t
        assert axis.gather_objects(3) == [3]
        assert (axis.reduce_sum(t) is t and axis.copy_in(t) is t
                and axis.gather(t, 0, True) is t)
    assert m.broadcast(t) is t
    m.barrier()
    assert mesh.gather_params({"blocks": [{"s_attn": {"qkv": {
        "kernel": t}}}]}, m)["blocks"][0]["s_attn"]["qkv"]["kernel"] is t
    grads = [torch.ones(3), torch.full((2, 2), 2.0)]
    mesh.all_reduce_grads(grads, m.data)
    assert grads[0].sum() == 3 and grads[1].sum() == 8
    assert mesh.process_batch_slice(6) == slice(0, 6)
    assert mesh.process_batch_slice(6, m.data) == slice(0, 6)
    assert mesh.data_position(mesh.MeshConfig()) == (0, 1)
    seeds = {mesh.rank_seed(s, i) for s in (0, 1) for i in range(4)}
    assert len(seeds) == 8
    # a fixed hash of (seed, index): the same videos on any Python
    assert mesh.rank_seed(7, 1) == 6635463128224577688
    assert mesh.rank_seed(-1, 0) == mesh.rank_seed(2**64 - 1, 0)
    with pytest.raises(ValueError, match="mesh 2x1"):
        mesh.make_mesh(mesh.MeshConfig(data=2))


# ------------------------------------------------ the callers' contracts

def test_rank_draws_are_the_global_batch_rows(tmp_path):
    """A rank's loss draws are its rows of the global batch's, drawn from
    the same generator state; at one rank, the batch's own."""
    from gtax_torch.sampling.diffusion import draw_loss_noise
    from tests.test_torch_train import _tiny_trainer

    tr = _tiny_trainer(tmp_path)
    lat = torch.zeros(2, 5, 8, 6, 8)
    whole = draw_loss_noise(lat, tr.loss_cfg, torch.Generator().manual_seed(
        4), batch=4)
    tr.world, tr.rank = 2, 1
    got = tr.rank_draws(lat, torch.Generator().manual_seed(4))
    for k, v in whole.items():
        assert torch.equal(got[k], v[:, 2:4]), k
    tr.world, tr.rank = 1, 0
    one = tr.rank_draws(lat, torch.Generator().manual_seed(4))
    mine = draw_loss_noise(lat, tr.loss_cfg, torch.Generator().manual_seed(4))
    assert all(torch.equal(one[k], mine[k]) for k in mine)


@pytest.mark.parametrize("option,error,match", [
    ({"mesh_model": 2}, ValueError, "mesh 0x2 != 1"),
    ({"mesh_data": 2, "mesh_model": 2}, ValueError, "mesh 2x2 != 1"),
    ({"mesh_data": 3}, ValueError, "mesh 3x1 != 1"),
])
def test_trainer_mesh_refusals(option, error, match):
    """mesh_data x mesh_model must equal the group's size (here one
    process); tensor-parallel training itself runs in
    tests/test_torch_tp_train.py."""
    with pytest.raises(error, match=match):
        check_slice(TrainingConfig.from_dict(
            dict(attention_backend="fused_all", dataset_type="dummy",
                 **option)))


@pytest.mark.parametrize("option,match", [
    ({"mesh_model": 2, "quantize": "int8"}, "int8"),
    ({"mesh_model": 2, "mesh_data": 2}, "mutually exclusive"),
])
def test_serving_mesh_refusals_as_gtax(option, match):
    """What gtax's VideoGenerator asserts, raised as ValueError before a
    group is needed."""
    cfg = serving.ServingConfig(dtype="float32", dit_model="DiT-debug",
                                vae_model="vae-debug", **option)
    with pytest.raises(ValueError, match=match):
        serving.VideoGenerator.load("", "", cfg, device="cpu")


@pytest.mark.parametrize("kw", [{"backend": "pallas"},
                                {"backend": "xla", "plain_branches": True}])
def test_dit_apply_tensor_parallel_needs_xla(kw):
    """tp runs the `xla` backend's unfused branches over the model axis
    (gtax's GSPMD path) or the fused branches on gathered blocks; not
    `pallas` (its kernels are forward-only and single-card) nor the plain
    kernel branches."""
    params = _small_params(False)
    x = torch.zeros(1, 3, 4, 4, 4)
    t = torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="tensor-parallel"):
        tdit.dit_apply(params, SMALL, x, t, compute_dtype=torch.float32,
                       tp=mesh.Axis(2, 0), **kw)
