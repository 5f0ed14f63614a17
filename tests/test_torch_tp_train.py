"""Tensor-parallel training in the port: gloo ranks on the CPU
(tests/_torch_mp_worker.py, which imports no JAX) against the port's one
process and against gtax's tensor-parallel Trainer on the same latent
clips, loss draws (gtax's, from LOSS_KEY, over the global batch) and
weights, DiT-debug in fp32 with nonzero adaLN heads.

- Two ranks (data=1 x model=2) under `xla`, `fused`, `fused_mlp`,
  `fused_all` and `fused_all` with int8_forward, and four (data=2 x
  model=2) under `xla` and `fused_all`, each against the port's one
  process and against gtax's Trainer on the same (data, model) mesh of
  conftest's virtual CPU devices (its per-device batch B / 2, so that its
  global batch, per device times every device, is the ranks' B * data;
  its Pallas kernels in interpret mode): step 1's loss within 1e-5
  relative, its grad norm within 1e-5 relative (the whole model's: the
  cut leaves' squares summed over the model axis), every leaf's gradient
  gathered whole and every master after the update within 1e-5 relative
  L2 (fp32 summation order; under int8_forward the norm to 1e-3 and the
  leaves to 1e-3, as tests/test_torch_train_modes.py: an int8 rounding
  flipped by the adaLN heads' other summation order moves a row by a
  step; against
  gtax the leaves and masters to 5e-3, tests/test_torch_int8_train.py's
  relative L2 rule for int8 gradients against gtax, since the port's and
  XLA's fp32 sums flip other roundings). Readings on the CPU: against
  gtax every gradient within 1.9e-6 and master within 3.9e-6 (the bf16
  backends, fp32 here), 1.4e-3 and 1.9e-4 under int8_forward (the port's
  one process against gtax reads the same 1.4e-3); against the port's one
  process every gradient within 3.7e-7. On the CPU the port's fused
  backends' kernels run as their plain versions.
- The data index, not the rank, picks the rows and the draws: the model
  ranks of a data index agree bit for bit.
- Checkpoints: a save at step 2 of the two-rank run resumes into a step 3
  bit-equal to the uninterrupted one (TP -> TP), and the saved files,
  which hold the whole weights, resume in one process into a step 3
  within 1e-6 (TP -> one process).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gtax_torch.data.loader import Batch
from gtax_torch.io.safetensors_port import dit_from_gtax, vae_from_gtax
from gtax_torch.models import vae as tvae
from gtax_torch.train import checkpoint as ckpt
from gtax_torch.train import trainer as ttrainer
from gtax_torch.train.config import TrainingConfig
from tests.test_torch_multiproc import _gtax_draws, _run
from tests.test_torch_train import (  # noqa: F401 (autouse fixture)
    JCFG, T, TCFG, _random_params, _torch_params, interpret_mode)
from tests.test_torch_train_modes import BASE, LOSS_KEY

torch.set_num_threads(2)

B = BASE["batch_size"]  # rows a data index
TOL, INT8_TOL = 1e-5, 1e-3
INT8_GTAX_TOL = 5e-3  # tests/test_torch_int8_train.py's int8 gradient rule
RUNS_MODEL2 = {"xla": {"attention_backend": "xla"},
               "fused": {"attention_backend": "fused"},
               "fused_mlp": {"attention_backend": "fused_mlp"},
               "fused_all": {"attention_backend": "fused_all"},
               "int8_forward": {"attention_backend": "fused_all",
                                "int8_forward": True}}
LAYOUTS = {"model2": (1, 2, RUNS_MODEL2),
           "data2_model2": (2, 2, {k: RUNS_MODEL2[k]
                                   for k in ("xla", "fused_all")})}


def _rel(got, ref):
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _one_process(cfg, over, jp, jv, lat, acts, draws):
    """The port's one-process step at the global batch, with the draws."""
    t_loss = ttrainer.diffusion_forcing_loss
    ttrainer.diffusion_forcing_loss = (
        lambda fn, la, ac, gen, *a: t_loss(fn, la, ac, None, *a,
                                           draws=draws))
    try:
        one = ttrainer.Trainer(
            TrainingConfig.from_dict(dict(cfg, **over, mesh_data=1,
                                          mesh_model=1,
                                          batch_size=lat.shape[1])),
            total_dataset_size=64, dit_cfg=TCFG, vae_cfg=tvae.VAE_debug(),
            dit_params=_torch_params(jp), vae_params=vae_from_gtax(jv),
            device="cpu")
        m = one.train_step_sync(Batch(torch.from_numpy(lat),
                                      torch.from_numpy(acts),
                                      is_latents=True))
    finally:
        ttrainer.diffusion_forcing_loss = t_loss
    grads = {k: v.grad.clone() for k, v in ckpt.flat(one.dit_params).items()
             if v.grad is not None}
    return m, grads, {k: v.detach().clone()
                      for k, v in ckpt.flat(one.dit_params).items()}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def tp_runs(request, tmp_path_factory):
    import jax

    from gtax.models import vae as jvae

    data, model, runs = LAYOUTS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = dict(BASE, output_dir=str(tmp / "out"), mesh_data=data,
               mesh_model=model)
    r = np.random.default_rng(3)
    lat = r.standard_normal((1, data * B, T, 8, 6, 8)).astype(np.float32)
    acts = r.standard_normal((1, data * B, T, 25)).astype(np.float32)
    draws = _gtax_draws(LOSS_KEY, T - BASE["n_prompt_frames"], data * B)
    jp = _random_params(4)
    jv = jax.tree.map(np.asarray, jvae.vae_init(jax.random.PRNGKey(1),
                                                jvae.VAE_debug()))
    # the ranks run while this process steps the two references
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run, "tp_train", tmp, {
            "config": cfg, "runs": runs, "params": _torch_params(jp),
            "vae": vae_from_gtax(jv), "latents": torch.from_numpy(lat),
            "actions": torch.from_numpy(acts), "draws": draws},
            world=data * model, timeout=240)
        ref = {name: _one_process(cfg, over, jp, jv, lat, acts, draws)
               for name, over in runs.items()}
        gtax = {name: _gtax_step(cfg, over, (data, model), jp, jv, lat,
                                 acts)
                for name, over in runs.items()}
        ranks = ranks.result()
    return (data, model), ranks, ref, gtax


def _gtax_step(cfg, over, shape, jp, jv, lat, acts):
    """gtax's Trainer, one step on a (data, model) mesh with the batch
    sharded on `data` (its draws from LOSS_KEY over the global batch): the
    metrics, the gradient as its optimizer receives it (a debug callback
    in front of its `tx.update`, traced at the first step) and the
    masters, in the port's layout. Its attention backend and int8 switch
    are process-wide and restored after."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gtax.data.loader import Batch as JBatch
    from gtax.kernels import attention as kattn
    from gtax.models import vae as jvae
    from gtax.nn import attention as jattn
    from gtax.nn import branches as jbr
    from gtax.parallel import mesh as jmesh
    from gtax.train import config as jconfig
    from gtax.train import trainer as jtrainer

    data, model = shape
    kattn.set_interpret(True)
    backend, int8 = jattn.get_backend(), jbr.use_int8_fwd()
    j_loss = jtrainer.diffusion_forcing_loss
    jtrainer.diffusion_forcing_loss = (
        lambda fn, la, ac, rng, *a: j_loss(fn, la, ac, LOSS_KEY, *a))
    seen = {}
    try:
        mesh = jmesh.make_mesh(jmesh.MeshConfig(data=data, model=model),
                               devices=jax.devices()[:data * model])
        jt = jtrainer.Trainer(
            jconfig.TrainingConfig.from_dict(dict(cfg, **over,
                                                  batch_size=B // model)),
            total_dataset_size=64, dit_cfg=JCFG, vae_cfg=jvae.VAE_debug(),
            dit_params=jax.tree.map(jnp.asarray, jp), vae_params=jv,
            mesh=mesh)
        tx = jt.tx

        def update(grads, state, params=None):
            jax.debug.callback(lambda g: seen.update(grads=g), grads)
            return tx.update(grads, state, params)

        jt.tx = optax.GradientTransformation(tx.init, update)
        sharded = NamedSharding(mesh, P(None, "data"))
        m = jt.train_step_sync(JBatch(video=jax.device_put(lat, sharded),
                                      actions=jax.device_put(acts, sharded),
                                      is_latents=True))
        masters = jax.tree.map(np.asarray, jt.dit_params)
    finally:
        jtrainer.diffusion_forcing_loss = j_loss
        jattn.set_backend(backend)
        jbr.set_int8_fwd(int8)
    assert jt.n_devices == data * model
    grads = ckpt.flat(dit_from_gtax(jax.tree.map(np.asarray, seen["grads"])))
    return m, grads, ckpt.flat(dit_from_gtax(masters))


def _check_against(tp_runs, against):
    (data, model), ranks, one, gtax = tp_runs
    ref = one if against == "port_one_process" else gtax
    for out in ranks:
        for name, got in out.items():
            metrics, grads, masters = ref[name]
            tol = norm_tol = TOL
            if name == "int8_forward":
                norm_tol = INT8_TOL
                tol = INT8_TOL if against == "port_one_process" else \
                    INT8_GTAX_TOL
            assert got["mesh"] == {"data": data, "model": model}
            assert got["qkv_cols"] == 3 * TCFG.hidden_size // model
            np.testing.assert_allclose(got["loss"], metrics["train_loss"],
                                       rtol=TOL, err_msg=name)
            np.testing.assert_allclose(got["grad_norm"],
                                       metrics["grad_norm"],
                                       rtol=norm_tol,
                                       err_msg=name)
            # jax.grad gives zeros where the port's leaf takes no .grad
            missing = grads.keys() - got["grads"].keys()
            assert all(against == "gtax" and not grads[k].any()
                       for k in missing), (name, missing)
            assert got["grads"].keys() <= grads.keys()
            for k in got["grads"]:
                g = grads[k]
                if g.norm() > 0:
                    assert _rel(got["grads"][k], g) <= tol, (name, k)
                else:
                    assert got["grads"][k].abs().max() <= 1e-12, (name, k)
            assert got["masters"].keys() == masters.keys()
            for k, v in masters.items():
                assert _rel(got["masters"][k], v) <= tol, (name, k)


def test_tp_train_matches_one_process(tp_runs):
    _check_against(tp_runs, "port_one_process")


def test_tp_train_matches_gtax(tp_runs):
    """The same readings against gtax's tensor-parallel Trainer: a fault
    that the port's TP path shared with its one process (the mesh's rules,
    the whole-model norm, the data index's rows and draws) shows here."""
    _check_against(tp_runs, "gtax")


def test_tp_fused_weights_gathered_again_in_the_backward(tp_runs):
    """Under fused_all each block's ten cut branch leaves (qkv and out of
    both attentions, fc1's kernel and bias and fc2 of both MLPs) are
    gathered in front of the block and, the whole copies freed, gathered
    again where the backward reads them; the adaLN heads' two outputs a
    block are gathered once. Under `xla` only those outputs are."""
    ranks = tp_runs[1]
    L = TCFG.depth
    for out in ranks:
        assert out["fused_all"]["gathers"] == 2 * 10 * L + 2 * L
        assert out["xla"]["gathers"] == 2 * L


def test_tp_train_ranks_agree(tp_runs):
    """Every rank holds the same whole masters after the step (the data
    all-reduce and the model gather); the model ranks of a data index
    report the same loss, bit for bit."""
    (data, model), ranks = tp_runs[:2]
    for name in ranks[0]:
        first = ranks[0][name]
        for r, out in enumerate(ranks):
            got = out[name]
            assert got["rank_data"] == r // model
            assert all(torch.equal(got["masters"][k], first["masters"][k])
                       for k in first["masters"]), (name, r)
            same_group = ranks[(r // model) * model][name]
            assert got["loss"] == same_group["loss"]
            assert got["grad_norm"] == first["grad_norm"]


@pytest.fixture(scope="module")
def tp_ckpt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    cfg = dict(BASE, output_dir=str(tmp / "out"), mesh_model=2,
               max_steps=3, save_every=2, resume_from_checkpoint=True,
               seed=3, vae_checkpoint="")
    return cfg, _run("tp_ckpt", tmp, {"config": cfg}, timeout=240)


def test_tp_checkpoint_resume_tp(tp_ckpt_runs):
    """TP -> TP: the resumed step 3 bit-equal to the uninterrupted one;
    the resumed trainer holds its shard of each moment."""
    _, ranks = tp_ckpt_runs
    for out in ranks:
        assert sorted(out["loss_a"]) == [1, 2, 3]
        assert list(out["loss_b"]) == [3]
        assert out["loss_b"][3] == out["loss_a"][3]
        assert all(torch.equal(out["final_b"][k], v)
                   for k, v in out["final_a"].items())
        nu = out["nu_shard"]["blocks/0/s_attn/qkv/kernel"]
        assert nu.shape == (TCFG.hidden_size, 3 * TCFG.hidden_size // 2)


def test_tp_checkpoint_resume_one_process(tp_ckpt_runs):
    """TP -> one process: the state the two ranks saved at step 2 (whole
    weights: it equals a one-process run's files) resumes in one process
    into a step 3 within 1e-6 of the ranks'."""
    cfg, ranks = tp_ckpt_runs
    one_cfg = TrainingConfig.from_dict(dict(cfg, mesh_model=1))
    train, _ = ttrainer.build_loaders(one_cfg, size=24)
    tr = ttrainer.Trainer(one_cfg, total_dataset_size=len(train.dataset),
                          dit_cfg=TCFG, vae_cfg=tvae.VAE_debug(),
                          device="cpu")
    seen = {}
    tr.training_loop(train, None, callbacks=[
        lambda t, m: seen.update({m["step"]: m["train_loss"]})])
    want = ranks[0]
    assert list(seen) == [3]
    np.testing.assert_allclose(seen[3], want["loss_b"][3], rtol=1e-6)
    for k, v in ckpt.flat(tr.dit_params).items():
        assert _rel(v.detach(), want["final_b"][k]) <= 1e-6, k
