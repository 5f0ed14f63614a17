"""The port on two processes: two ranks over gloo on the CPU
(tests/_torch_mp_worker.py, which imports no JAX) against gtax in this
process (conftest's virtual CPU devices) and against the port's one
process, at DiT-debug / vae-debug in fp32.

- Data-parallel training (`xla`): two steps of two ranks of B=2 against
  gtax's Trainer on a data=2 mesh at the global B=4, from the same weights,
  the
  same latent batch and gtax's draws over the global batch (each rank
  keeps its rows, Trainer.rank_draws): losses within 1e-5 relative and
  every master leaf within 1e-5 relative L2, gradient norms within 1e-4
  (fp32 summation order, as test_torch_train_modes.py); the same bars
  against the port's one process at B=4; the ranks' losses and masters
  bit-equal.
- Checkpoints: a save at step 2 writes one export and one state; the
  resumed step 3 is bit-equal to the uninterrupted one on both ranks; the
  metrics file has one record a step (gtax wrote one a process).
- The stream cursor: two tar shards of unequal length, one a rank,
  stopped at different counts; each rank's resumed stream continues its
  own (gtax restored rank 0's cursor on every rank).
- Batched serving (mesh_data=2): each rank's rows bit-equal to the
  one-process rollout of those rows with that rank's seed, fp32 and int8;
  the ranks' draws differ; noise= and a batch that does not divide are
  refused.
- Tensor-parallel serving (mesh_model=2), stacked and unstacked: the
  rollout within gtax's 2e-4 (tests/test_serving_tp.py) of gtax's `xla`
  rollout on the same injected noise and of the port's one process; the
  ranks' pixels bit-equal.

Each pair meets over a file:// store in its own tmp directory (no port to
race for under xdist) with a 60 s timeout in init_process_group; the
parent polls both ranks and kills both when one fails or the pair passes
its time limit (a dead peer would leave gloo waiting 30 minutes).
"""

import ast
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gtax import serving as jserving
from gtax.data.loader import Batch as JBatch
from gtax.kernels import attention as kattn
from gtax.models import vae as jvae
from gtax.nn import attention as jattn
from gtax.parallel import mesh as jmesh
from gtax.train import config as jconfig
from gtax.train import trainer as jtrainer
from gtax_torch.data.loader import Batch
from gtax_torch.io.safetensors_port import dit_from_gtax, vae_from_gtax
from gtax_torch.models import vae as tvae
from gtax_torch.train import checkpoint as ckpt
from gtax_torch.train import trainer as ttrainer
from gtax_torch.train.config import TrainingConfig
from tests.test_torch_models import _gtax_debug_params
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    JCFG, T, TCFG, _random_params, _torch_params, interpret_mode)
from tests.test_torch_isolation import _forbidden, _imports
from tests.test_torch_train_modes import BASE, LOSS_KEY

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_mp_worker.py"
WORLD, B = 2, BASE["batch_size"]  # B rows a rank


def _run(case, tmp, inputs=None, env_mode=False, timeout=150, world=WORLD):
    """Run `case` on `world` ranks (two by default) in `tmp`; returns their
    outputs.
    env_mode: the ranks join through gtax's GTAX_* environment."""
    tmp.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(env)
            if env_mode:
                e.update(GTAX_COORDINATOR=f"file://{tmp}/store",
                         GTAX_NUM_PROCESSES=str(world),
                         GTAX_PROCESS_ID=str(r))
            logs.append(open(tmp / f"log_{r}.txt", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), case, str(r), str(world),
                 str(tmp)], cwd=tmp, env=e, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} exited {p.returncode}:\n"
            + (tmp / f"log_{r}.txt").read_text()[-4000:])
    return [torch.load(tmp / f"out_{r}.pt", weights_only=True)
            for r in range(world)]


def _masters_close(got, ref, tol):
    """Every master within a relative L2 of tol (an element whose gradient
    is near zero can take AdamW's update of either sign under fp32
    rounding, so the largest element difference is not the measure)."""
    assert got.keys() == ref.keys()
    worst = max(float((got[k] - ref[k].detach()).norm()
                      / ref[k].detach().norm().clamp_min(1e-30))
                for k in ref)
    assert worst <= tol, worst


# ------------------------------------------------------------ training

def _gtax_draws(key, n_gen, batch):
    """gtax diffusion_forcing_loss's draws from `key` over `batch` clips
    (test_torch_loss.py's replay, at any batch)."""
    k_t, k_c, k_noise = jax.random.split(key, 3)
    target = jax.random.randint(k_t, (n_gen, batch), 1,
                                BASE["ddim_noise_steps"] + 1)
    ctx = jax.random.randint(k_c, (n_gen, batch), 1,
                             BASE["ctx_max_noise_idx"] + 1)
    ctx_noise, last_noise = [], []
    for idx in range(n_gen):
        k_ctx, k_last = jax.random.split(jax.random.fold_in(k_noise, idx))
        ctx_noise.append(jax.random.normal(k_ctx, (batch, T - 1, 8, 6, 8)))
        last_noise.append(jax.random.normal(k_last, (batch, 1, 8, 6, 8)))

    def t_(a):
        return torch.from_numpy(np.array(a))

    return {"target_idx": t_(target).long(), "ctx_idx": t_(ctx).long(),
            "ctx_noise": t_(jnp.stack(ctx_noise)),
            "last_noise": t_(jnp.stack(last_noise))}


@pytest.fixture(scope="module")
def dp_train_runs(tmp_path_factory):
    """(ranks' outputs, gtax's metrics and masters, the port's one-process
    metrics and masters) of two steps from the same start."""
    tmp = tmp_path_factory.mktemp("dp_train")
    # `xla`: gtax's step compiles in a third less time than under
    # fused_all's interpreted kernels; the reduce does not see the backend
    cfg = dict(BASE, output_dir=str(tmp / "out"), mesh_data=WORLD,
               attention_backend="xla")
    r = np.random.default_rng(2)
    lat = r.standard_normal((1, WORLD * B, T, 8, 6, 8)).astype(np.float32)
    acts = r.standard_normal((1, WORLD * B, T, 25)).astype(np.float32)
    draws = _gtax_draws(LOSS_KEY, T - BASE["n_prompt_frames"], WORLD * B)
    jp = _random_params(0)
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    ranks = _run("dp_train", tmp, {
        "config": cfg, "params": _torch_params(jp),
        "vae": vae_from_gtax(jax.tree.map(np.asarray, jv)),
        "latents": torch.from_numpy(lat), "actions": torch.from_numpy(acts),
        "draws": draws})

    # gtax: its Trainer over a data=2 mesh, the batch sharded on it (its
    # Pallas kernels in interpret mode, its backend restored after)
    kattn.set_interpret(True)
    backend = jattn.get_backend()
    j_loss = jtrainer.diffusion_forcing_loss
    jtrainer.diffusion_forcing_loss = (
        lambda fn, lat, act, rng, *a: j_loss(fn, lat, act, LOSS_KEY, *a))
    try:
        mesh = jmesh.make_mesh(jmesh.MeshConfig(data=WORLD),
                               devices=jax.devices()[:WORLD])
        jt = jtrainer.Trainer(jconfig.TrainingConfig.from_dict(cfg),
                              total_dataset_size=64, dit_cfg=JCFG,
                              vae_cfg=jvae.VAE_debug(),
                              dit_params=jax.tree.map(jnp.asarray, jp),
                              vae_params=jv, mesh=mesh)
        sharded = NamedSharding(mesh, P(None, "data"))
        jb = JBatch(video=jax.device_put(lat, sharded),
                            actions=jax.device_put(acts, sharded),
                            is_latents=True)
        ref = [jt.train_step_sync(jb) for _ in range(2)]
        jmasters = ckpt.flat(dit_from_gtax(jax.tree.map(np.asarray,
                                                        jt.dit_params)))
    finally:
        jtrainer.diffusion_forcing_loss = j_loss
        jattn.set_backend(backend)

    # the port's one process at the global batch, with the same draws
    t_loss = ttrainer.diffusion_forcing_loss
    ttrainer.diffusion_forcing_loss = (
        lambda fn, lat, act, gen, *a: t_loss(fn, lat, act, None, *a,
                                             draws=draws))
    try:
        one = ttrainer.Trainer(
            TrainingConfig.from_dict(
                dict(cfg, batch_size=WORLD * B, mesh_data=1)),
            total_dataset_size=64, dit_cfg=TCFG, vae_cfg=tvae.VAE_debug(),
            dit_params=_torch_params(jp),
            vae_params=vae_from_gtax(jax.tree.map(np.asarray, jv)),
            device="cpu")
        tb = Batch(torch.from_numpy(lat), torch.from_numpy(acts),
                   is_latents=True)
        own = [one.train_step_sync(tb) for _ in range(2)]
    finally:
        ttrainer.diffusion_forcing_loss = t_loss
    return ranks, (ref, jmasters), (own, ckpt.flat(one.dit_params))


@pytest.mark.parametrize("against", ["gtax_data2", "port_one_process"])
def test_dp_train_matches(dp_train_runs, against):
    """Both ranks' two steps against gtax's data=2 trainer, or the port's
    one process at the global batch."""
    ranks, gtax, one = dp_train_runs
    metrics, masters = gtax if against == "gtax_data2" else one
    for out in ranks:
        assert out["world"] == WORLD
        assert out["steps_per_epoch"] == 64 // (WORLD * B)
        np.testing.assert_allclose(out["loss"],
                                   [m["train_loss"] for m in metrics],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"],
                                   [m["grad_norm"] for m in metrics],
                                   rtol=1e-4)
        _masters_close(out["masters"], masters, 1e-5)


def test_dp_train_ranks_agree(dp_train_runs):
    """The two ranks report the same losses and hold the same masters, bit
    for bit (rank 1 started from other weights: the broadcast)."""
    a, b = dp_train_runs[0]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert all(torch.equal(a["masters"][k], b["masters"][k])
               for k in a["masters"])


@pytest.fixture(scope="module")
def dp_ckpt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ckpt")
    cfg = dict(BASE, output_dir=str(tmp / "out"), mesh_data=WORLD,
               max_steps=3, save_every=2, resume_from_checkpoint=True,
               seed=3, vae_checkpoint="")
    return _run("dp_ckpt", tmp, {"config": cfg})


def test_dp_checkpoint_resume(dp_ckpt_runs):
    """A save at step 2 writes one export and one state; both ranks resume
    from it (two batches of their stride skipped) into a step 3 bit-equal
    to the uninterrupted one."""
    for out in dp_ckpt_runs:
        assert out["exports"] == ["m_epoch_1_2.safetensors"]
        assert out["states"] == ["state_2", "step.json"]
        assert sorted(out["loss_a"]) == [1, 2, 3]
        assert list(out["loss_b"]) == [3] and out["skip_b"] == 2
        assert out["loss_b"][3] == out["loss_a"][3]
        assert all(torch.equal(out["final_b"][k], v)
                   for k, v in out["final_a"].items())
    assert dp_ckpt_runs[0]["loss_a"] == dp_ckpt_runs[1]["loss_a"]


def test_dp_metrics_one_record_a_step(dp_ckpt_runs):
    """The metrics JSONL is rank 0's: one record a step (gtax appended one
    on every process)."""
    records = dp_ckpt_runs[0]["records"]
    steps = [r["step"] for r in records if "train_loss" in r]
    assert steps == [1, 2, 3]


def test_dp_cursor_per_rank(tmp_path):
    """Rank 0 streams a 4-clip shard, rank 1 a 7-clip one; stopped after 3
    and 5 clips, saved, resumed: each continues its own stream (with rank
    0's cursor on both, as gtax restores it, rank 1 would replay clips
    3-4)."""
    from tests.test_torch_data import _shard

    shards = []
    for i, n in enumerate((4, 7)):
        shards.append(str(tmp_path / f"{i:05d}.tar"))
        _shard(shards[-1], 100 * i, n, with_json=False)
    cfg = dict(BASE, output_dir=str(tmp_path / "out"), mesh_data=WORLD,
               vae_checkpoint="")
    outs = _run("cursor", tmp_path / "run", {
        "config": cfg, "shards": shards, "stop_at": [3, 5]})
    assert outs[0]["cursors"] == [[0, 0, 3], [0, 0, 5]]
    for out in outs:
        k = out["k"]
        assert len(out["resumed"]) == 6
        for got, want in zip(out["resumed"], out["whole"][k:k + 6]):
            assert torch.equal(got, want)


# ------------------------------------------------------------- serving

def _serving_weights():
    """DiT-debug with nonzero adaLN heads and biases (a bias added on
    every model rank instead of once would show), and the VAE."""
    _, jp = _gtax_debug_params()
    r = np.random.default_rng(9)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + (0.02 * r.standard_normal(a.shape)).astype(
            a.dtype) if getattr(path[-1], "key", None) == "bias" else a, jp)
    jv = jvae.vae_init(jax.random.PRNGKey(1), jvae.VAE_debug())
    jv = jax.tree.map(lambda a: np.asarray(a + 0.01 if a.ndim == 1 else a),
                      jv)
    return jp, jv


@pytest.fixture(scope="module")
def dp_serve_runs(tmp_path_factory):
    """The two ranks of mesh_data=2, joined through the GTAX_* environment;
    one prompt repeated over the global batch of 4."""
    jp, jv = _serving_weights()
    r = np.random.default_rng(5)
    video = np.repeat(r.random((1, 4, 3, 48, 64), np.float32), 4, axis=0)
    acts = np.repeat(r.standard_normal((1, 6, 25)).astype(np.float32), 4,
                     axis=0)
    return _run("dp_serve", tmp_path_factory.mktemp("dp_serve"), {
        "params": dit_from_gtax(jp), "vae": vae_from_gtax(jv),
        "video": torch.from_numpy(video), "actions": torch.from_numpy(acts)},
        env_mode=True)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_dp_serving_rows_equal_one_process(dp_serve_runs, quantize):
    """Each rank's 2 rows bit-equal the one-process generate of those rows
    with the rank's seed (mesh.rank_seed)."""
    for out in dp_serve_runs:
        got, ref = out[quantize]
        assert got.shape == (2, 6, 48, 64, 3) and got.dtype == torch.uint8
        assert torch.equal(got, ref)
        assert out["mesh"] == {"data": WORLD, "model": 1}


def test_dp_serving_ranks_draw_apart(dp_serve_runs):
    """The same prompt on every row: the ranks' rows differ (their
    generators differ), as do a rank's two rows."""
    a, b = (out["none"][0] for out in dp_serve_runs)
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1])


def test_dp_serving_refusals(dp_serve_runs):
    """noise=, a batch of 3 over 2 ranks and a 1x1 mesh in the group of
    two (every rank would roll out the whole batch) raise ValueError."""
    for out in dp_serve_runs:
        noise, batch, mesh1 = out["refused"]
        assert "single-mesh" in noise and "must divide" in batch
        assert "mesh 1x1 != 2" in mesh1


@pytest.fixture(scope="module")
def tp_serve_runs(tmp_path_factory):
    """The two ranks of mesh_model=2 and gtax's `xla` rollout on the same
    prompt latents, actions and injected noise."""
    kattn.set_interpret(True)
    jp, jv = _serving_weights()
    r = np.random.default_rng(6)
    prompt = r.standard_normal((1, 2, 8, 6, 8)).astype(np.float32)
    noise = r.standard_normal((1, 2, 8, 6, 8)).astype(np.float32)
    acts = r.standard_normal((1, 4, 25)).astype(np.float32)
    video = r.random((1, 2, 3, 48, 64), np.float32)
    ranks = _run("tp_serve", tmp_path_factory.mktemp("tp_serve"), {
        "params": dit_from_gtax(jp), "vae": vae_from_gtax(jv),
        "prompt": torch.from_numpy(prompt), "noise": torch.from_numpy(noise),
        "actions": torch.from_numpy(acts), "video": torch.from_numpy(video)})
    jgen = jserving.VideoGenerator(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, jv),
        jserving.ServingConfig(dtype="float32", noise_steps=3,
                               attention_backend="xla",
                               dit_model="DiT-debug", vae_model="vae-debug"))
    with jattn.backend_scope("xla"):
        ref = jgen._rollout(jgen.dit_params, jnp.asarray(prompt),
                            jnp.asarray(acts), jax.random.PRNGKey(0),
                            num_gen_frames=2, noise=jnp.asarray(noise))
    return ranks, np.asarray(ref)


@pytest.mark.parametrize("layout", ["unstacked", "stacked"])
def test_tp_serving_matches(tp_serve_runs, layout):
    """Both ranks' rollout within 2e-4 of gtax's and of the port's one
    process; the params were cut (1 of the 2 heads a rank) and the backend
    forced to `xla`."""
    ranks, ref = tp_serve_runs
    for out in ranks:
        got = out[layout]
        assert got["backend"] == "xla" and got["qkv_cols"] == 3 * 64 // 2
        np.testing.assert_allclose(got["tp"].numpy(), ref, atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(got["tp"].numpy(), got["one"].numpy(),
                                   atol=2e-4, rtol=2e-4)


def test_tp_serving_ranks_agree(tp_serve_runs):
    """Every rank returns the same pixels, in both layouts."""
    a, b = tp_serve_runs[0]
    for layout in ("unstacked", "stacked"):
        assert torch.equal(a[layout]["pixels"], b[layout]["pixels"])
        assert torch.equal(a[layout]["tp"], b[layout]["tp"])


def test_worker_imports_no_jax():
    """The ranks run the port alone: the worker imports nothing of JAX or
    gtax (tests/test_torch_isolation.py's rule)."""
    tree = ast.parse(WORKER.read_text())
    assert not [n for _, n in _imports(tree) if _forbidden(n)]
