"""The port's training path on the CPU against gtax: the DiT's full
gradient, the schedule, the optimizer, the config, the data, and the
Trainer's loop (the loss is in test_torch_loss.py).

Inputs are numpy arrays from seeds handed to both sides; gtax runs its
`fused_all` backend (Pallas kernels in interpret mode, as gtax's own CPU
tests run them), the port its plain versions, both in fp32. Tolerances:
atol 1e-4 of a gradient leaf's largest magnitude, rtol 5e-4 (gtax's
backward-test tolerance: the two sides differ in summation order only);
losses and optimizer updates to 1e-6 relative (fp32 rounding).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gtax.data.dummy import DummyDataset as JDummy
from gtax.data.loader import DataLoader as JLoader
from gtax.kernels import attention as kattn
from gtax.models import dit as jdit
from gtax.nn import attention as jattn
from gtax.train import config as jconfig
from gtax.train import optim as joptim
from gtax.utils import profiling as jprof
from gtax_torch.data.dummy import DummyDataset
from gtax_torch.data.loader import Batch, DataLoader
from gtax_torch.io.safetensors_port import dit_from_gtax
from gtax_torch.models import dit as tdit
from gtax_torch.models.vae import VAEConfig, vae_init
from gtax_torch.train import optim as toptim
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.optim import leaves
from gtax_torch.train.trainer import Trainer, check_slice
from gtax_torch.utils.profiling import dit_forward_flops

torch.set_num_threads(2)

JCFG = jdit.DiT_debug()
TCFG = tdit.DiT_debug()
B, T = 2, 5


@pytest.fixture(autouse=True)
def interpret_mode():
    kattn.set_interpret(True)
    yield
    kattn.set_interpret(None)


def _fused_all(fn):
    """Run fn under gtax's fused_all backend (global state), restored."""
    prev = jattn.get_backend()
    jattn.set_backend("fused_all")
    try:
        return fn()
    finally:
        jattn.set_backend(prev)


def _random_params(seed, std=0.05):
    """gtax DiT_debug params with every leaf but the rope tables drawn
    normal * std (dit_init zeroes the adaLN heads, which gates every branch
    and its gradient to zero)."""
    r = np.random.default_rng(seed)
    tree = jdit.dit_init(jax.random.PRNGKey(0), JCFG)

    def draw(path, leaf):
        keys = {str(getattr(p, "key", p)) for p in path}
        if keys & {"spatial_rope_freqs", "temporal_rope_freqs"}:
            return np.asarray(leaf)
        return (r.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _torch_params(tree):
    return dit_from_gtax(tree)


def _port_params(seed, std=0.05):
    """The port's DiT_debug params drawn as _random_params draws gtax's
    (every leaf but the rope tables normal * std, from a numpy seed),
    with no JAX: for the tests that hold the port against itself (the
    interpret_mode fixture clears JAX's caches around every test, so a
    JAX-made tree would compile again each time)."""
    r = np.random.default_rng(seed)
    frozen = ("spatial_rope_freqs", "temporal_rope_freqs")
    return tdit._map_params(
        tdit.dit_init(TCFG, torch.Generator().manual_seed(0)),
        lambda path, leaf: leaf if path[-1] in frozen else torch.from_numpy(
            (r.standard_normal(tuple(leaf.shape)) * std).astype(np.float32)))


def _leaf_grads(params):
    return [(path, p.grad) for path, p in leaves(params)]


def _check_grads(tparams, jgrads):
    """Every gradient leaf against gtax's; the rope tables get none here
    (gtax: zero)."""
    ref = dict(leaves(dit_from_gtax(jax.tree.map(np.asarray, jgrads))))
    n = 0
    for path, p in leaves(tparams):
        want = ref[path].numpy()
        if p.grad is None:
            assert not np.any(want), path
            continue
        got = p.grad.numpy()
        scale = max(1e-8, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=5e-4,
                                   err_msg=str(path))
        n += 1
    assert n > 20


def _requires_grad(params):
    for path, p in leaves(params):
        p.requires_grad_(toptim.decays(path))
    return params


def test_dit_apply_gradient_matches_jax_grad():
    """dit_apply's gradient w.r.t. every parameter (trainable branches:
    forward with emit_train, the backwards' plain versions) against
    jax.grad of gtax's dit_apply under attention_backend="fused_all"."""
    r = np.random.default_rng(1)
    jp = _random_params(0)
    x = r.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    t = r.integers(0, 1000, (B, T)).astype(np.int32)
    a = r.standard_normal((B, T, 25)).astype(np.float32)
    ct = r.standard_normal((B, T, 8, 6, 8)).astype(np.float32)
    valid = np.array([False, True, True, True, True])

    def jloss(p):
        v = jdit.dit_apply(p, JCFG, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(a), jnp.asarray(valid),
                           compute_dtype=jnp.float32)
        return jnp.sum(v * ct)

    jgrads = _fused_all(lambda: jax.grad(jloss)(
        jax.tree.map(jnp.asarray, jp)))
    tp = _requires_grad(_torch_params(jp))
    v = tdit.dit_apply(tp, TCFG, torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(a), list(valid),
                       compute_dtype=torch.float32)
    (v * torch.from_numpy(ct)).sum().backward()
    _check_grads(tp, jgrads)


def test_plain_branches_gradient_matches_kernel_path():
    """plain_branches=True (the xla_* forwards under autograd) gives the
    same gradients as the trainable branches (fp32, CPU)."""
    r = np.random.default_rng(2)
    jp = _random_params(3)
    x = torch.from_numpy(r.standard_normal((1, T, 8, 6, 8)).astype(
        np.float32))
    t = torch.from_numpy(r.integers(0, 1000, (1, T)))
    grads = []
    for plain in (False, True):
        tp = _requires_grad(_torch_params(jp))
        tdit.dit_apply(tp, TCFG, x, t, None, None,
                       compute_dtype=torch.float32,
                       plain_branches=plain).square().sum().backward()
        grads.append([g for _, g in _leaf_grads(tp)])
    for a, b in zip(*grads):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(),
                                   rtol=5e-4)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_nb"])
@pytest.mark.parametrize("mode", ["fused_all", "xla", "int8_fwd"])
def test_dit_apply_remat_bit_equal(mode, policy):
    """block_remat recomputes each block in the backward and draws nothing:
    the output and every gradient bit-equal to block_remat off, under each
    remat_policy, on the kernel path (`fused_all`), the unfused path
    (`xla`) and the int8 forward (fp32, CPU)."""
    r = np.random.default_rng(13)
    base = _port_params(14)
    x, ct = (torch.from_numpy(r.standard_normal((B, T, 8, 6, 8)).astype(
        np.float32)) for _ in range(2))
    t = torch.from_numpy(r.integers(0, 1000, (B, T)))
    kw = ({"int8_fwd": True} if mode == "int8_fwd" else {"backend": mode})
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, block_remat=remat,
                                  remat_policy=policy)
        tp = _requires_grad(tdit._map_params(base, lambda _, l: l.clone()))
        v = tdit.dit_apply(tp, cfg, x, t, None, [False] + [True] * 4,
                           compute_dtype=torch.float32, **kw)
        (v * ct).sum().backward()
        runs.append((v.detach(), _leaf_grads(tp)))
    assert torch.equal(runs[0][0], runs[1][0])
    n = 0
    for (path, g0), (_, g1) in zip(runs[0][1], runs[1][1]):
        assert (g0 is None) == (g1 is None), path
        if g0 is not None:
            assert torch.equal(g0, g1), path
            n += 1
    assert n > 20


def test_remat_policy_names_are_gtax_s():
    """gtax's three remat policies run; another name raises."""
    cfg = dataclasses.replace(TCFG, block_remat=True, remat_policy="some")
    tp = _requires_grad(tdit.dit_init(TCFG, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="remat_policy"):
        tdit.dit_apply(tp, cfg, torch.zeros(1, T, 8, 6, 8),
                       torch.zeros(1, T, dtype=torch.long),
                       compute_dtype=torch.float32)


# ------------------------------------------------- schedule and optimizer

@pytest.mark.parametrize("args", [(1e-4, 1e-5, 10, 100), (1e-4, 1e-4, 3, 50),
                                  (3e-4, 0.0, 0, 20)])
def test_schedule_matches_gtax(args):
    jfn = joptim.cosine_min_lr_schedule(*args)
    tfn = toptim.cosine_min_lr_schedule(*args)
    for step in (0, 1, 2, 5, 10, 11, 37, 50, 99, 100, 150):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def test_adamw_update_matches_optax():
    """Three clip + AdamW updates (mu stored in bf16, weight decay masked
    off the rope tables) against gtax's optax chain, jitted as gtax's train
    step runs it; the first step's norm is under max_grad_norm, the others
    over it."""
    r = np.random.default_rng(9)
    tree = {"spatial_rope_freqs": r.standard_normal(8).astype(np.float32),
            "blocks": [{"w": r.standard_normal((4, 6)).astype(np.float32)}],
            "final": {"kernel": r.standard_normal((6, 3)).astype(np.float32),
                      "bias": r.standard_normal(3).astype(np.float32)}}
    grads = [jax.tree.map(
        lambda a, s=s: (r.standard_normal(a.shape) * s).astype(np.float32),
        tree) for s in (0.01, 2.0, 5.0)]
    for g in grads:
        g["spatial_rope_freqs"] = np.zeros(8, np.float32)
    tx, _ = joptim.make_optimizer(1e-2, 1e-3, 1, 10, weight_decay=0.1,
                                  max_grad_norm=1.0, mu_dtype=jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {"spatial_rope_freqs": torch.tensor(tree["spatial_rope_freqs"]),
          "blocks": [{"w": torch.tensor(tree["blocks"][0]["w"])}],
          "final": {k: torch.tensor(v) for k, v in tree["final"].items()}}
    opt, _ = toptim.make_optimizer(tp, 1e-2, 1e-3, 1, 10, weight_decay=0.1,
                                   max_grad_norm=1.0, mu_dtype=torch.bfloat16)
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        by_path = dict(leaves(g))
        norm = opt.step([torch.from_numpy(by_path[p]) for p in opt.paths])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
    want = dict(leaves(jax.tree.map(np.asarray, jp)))
    for path, a in leaves(tp):
        np.testing.assert_allclose(a.numpy(), want[path], rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    np.testing.assert_array_equal(tp["spatial_rope_freqs"].numpy(),
                                  tree["spatial_rope_freqs"])


# --------------------------------------------- config, flops, data, loop

def test_config_keys_defaults_and_coercion():
    tf = {f.name: f.default for f in dataclasses.fields(TrainingConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(
        jconfig.TrainingConfig)}
    assert tf == jf
    raw = {"warnup_ratio": "1e-1", "learning_rate": "3e-4",
           "batch_size": 4}
    assert (TrainingConfig.from_dict(raw).to_dict()
            == jconfig.TrainingConfig.from_dict(raw).to_dict())
    with pytest.raises(ValueError, match="Unknown"):
        TrainingConfig.from_dict({"nope": 1})


@pytest.mark.parametrize("option,error", [
    ({"attention_backend": "pallas"}, ValueError),
    ({"attention_backend": "xla", "int8_forward": True}, ValueError),
    ({"attention_backend": "fused_mlp", "int8_forward": True}, ValueError),
    ({"mesh_data": 2}, ValueError),
    ({"mesh_model": 2}, ValueError)])
def test_unported_options_raise(option, error):
    """`pallas` cannot train (its attention kernels refuse a gradient, as
    gtax's Pallas attention has none), int8_forward needs a fused
    attention backend (gtax asserts it), mesh_data x mesh_model must equal
    the process group's size (here one process; tensor-parallel training
    runs in tests/test_torch_tp_train.py)."""
    base = dict(attention_backend="fused_all", dataset_type="dummy",
                save_every=0)
    with pytest.raises(error):
        check_slice(TrainingConfig.from_dict({**base, **option}))


@pytest.mark.parametrize("option", [
    {"profile_dir": "/tmp/p"}, {"save_every": 10},
    {"dataset_type": "webdataset"}, {"dataset_type": "hfdataset"},
    {"attention_backend": "xla"}, {"attention_backend": "fused"},
    {"attention_backend": "fused_mlp"}, {"int8_forward": True},
    {"attention_backend": "fused", "int8_forward": True}, {"remat": True},
    {"unstack_train": False}])
def test_ported_options_accepted(option):
    """The options the ported slices run pass check_slice: the checkpoint
    and data options, the training backends but `pallas`, int8_forward
    under `fused` / `fused_all`, remat and the stacked layout."""
    base = dict(attention_backend="fused_all", dataset_type="dummy",
                save_every=0)
    check_slice(TrainingConfig.from_dict({**base, **option}))


def test_flops_match_gtax():
    for jc, tc in ((jdit.DiT_S_2(), tdit.DiT_S_2()), (JCFG, TCFG)):
        assert dit_forward_flops(tc, 16, 5) == jprof.dit_forward_flops(
            jc, 16, 5)


def test_dummy_data_and_loader_match_gtax():
    kw = dict(split="train", return_actions=True, height=8, width=12,
              seed=3, size=10)
    tds, jds = DummyDataset(**kw), JDummy(**kw)
    for i in range(10):
        a, b = tds[i], jds[i]
        np.testing.assert_array_equal(a["video"], b["video"])
        np.testing.assert_array_equal(a["actions"], b["actions"])
    tl = DataLoader(tds, batch_size=3, seed=5)
    jl = JLoader(jds, batch_size=3, num_workers=1, seed=5)
    for _ in range(2):  # two epochs: the same per-epoch shuffles
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == len(tl) == 3
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.video, b.video)
            np.testing.assert_array_equal(a.actions, b.actions)


def test_trainer_encode_matches_gtax_unfused_vae(monkeypatch):
    """gtax's trainer encodes the frozen VAE unfused (encode_frames'
    default, fused=False), its attention under the trainer's backend; the
    port's Trainer.encode does the same: no fused VAE block call, one
    attention call per encoder block under `fused_all`. bf16 on a
    vae-debug batch with the same weights (vae_from_gtax): every latent
    within 2**-7 of the largest one (under one bf16 ulp at the top of the
    range: the two sides round at the same points and sum in another
    order)."""
    from gtax.models import vae as jvae
    from gtax.train import trainer as jtrainer
    from gtax_torch.io.safetensors_port import vae_from_gtax
    from gtax_torch.models import vae as tvae

    backends = []

    def fused_block(*args):
        raise AssertionError("the trainer encoded through the fused block")

    def attention(*args, backend):
        backends.append(backend)
        return frame_attention(*args, backend=backend)

    frame_attention = tvae.attn.vae_frame_attention
    monkeypatch.setattr(tvae, "fused_vae_block", fused_block)
    monkeypatch.setattr(tvae.attn, "vae_frame_attention", attention)

    jcfg = jvae.VAE_debug()
    jp = jvae.vae_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda l: l + 0.01 if l.ndim == 1 else l, jp)
    cfg = dict(dataset_type="dummy", attention_backend="fused_all",
               save_every=0, use_wandb=False, compute_dtype="bfloat16",
               dit_model="DiT-debug", vae_model="vae-debug", batch_size=2)
    trainer = Trainer(TrainingConfig.from_dict(cfg), total_dataset_size=8,
                      vae_params=vae_from_gtax(jax.tree.map(np.asarray, jp)),
                      device="cpu")
    frames = np.random.default_rng(0).random((2, 5, 3, 48, 64), np.float32)
    got = trainer.encode(torch.from_numpy(frames)).numpy()
    ref = np.asarray(_fused_all(lambda: jtrainer.encode_frames(
        jp, jcfg, jnp.asarray(frames), jnp.bfloat16)))
    assert backends == ["fused_all"] * tvae.VAE_debug().enc_depth
    assert got.shape == ref.shape == (2, 5, 8, 6, 8)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0**-7 * np.abs(ref).max())


TINY_DIT = tdit.DiTConfig(input_h=6, input_w=8, patch_size=2, in_channels=4,
                          hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0,
                          external_cond_dim=25, max_frames=5)
TINY_VAE = VAEConfig(latent_dim=4, input_height=48, input_width=64,
                     patch_size=8, enc_dim=32, enc_depth=1, enc_heads=2,
                     dec_dim=32, dec_depth=1, dec_heads=2, mlp_ratio=2.0)


def _tiny_trainer(tmp_path, **overrides):
    cfg = dict(dataset_type="dummy", batch_size=2, validation_batch_size=2,
               num_epochs=1, max_steps=6, gradient_accumulation_steps=1,
               ddim_noise_steps=8, ctx_max_noise_idx=3, n_prompt_frames=4,
               use_wandb=False, learning_rate=1e-3, min_learning_rate=1e-4,
               weight_decay=0.0, output_dir=str(tmp_path),
               compute_dtype="float32", validation_steps=0, save_every=0,
               logging_steps=1, attention_backend="fused_all")
    cfg.update(overrides)
    gen = torch.Generator().manual_seed(0)
    return Trainer(TrainingConfig.from_dict(cfg), total_dataset_size=64,
                   dit_cfg=TINY_DIT, vae_cfg=TINY_VAE,
                   dit_params=tdit.dit_init(TINY_DIT, gen),
                   vae_params=vae_init(TINY_VAE, gen), device="cpu")


def _dummy_batch(n=2):
    ds = DummyDataset("train", return_actions=True, height=48, width=64)
    b = next(iter(DataLoader(ds, batch_size=n, shuffle=False)))
    return Batch(torch.from_numpy(b.video[None]),
                 torch.from_numpy(b.actions[None]))


def test_trainer_steps_lower_the_loss(tmp_path):
    """Six steps on one dummy batch in fp32 on the CPU lower the loss at
    fixed draws; every metric is finite and the parameters moved."""
    trainer = _tiny_trainer(tmp_path)
    batch = _dummy_batch()
    before = {p: t.detach().clone() for p, t in leaves(trainer.dit_params)}

    def fixed_loss():
        with torch.no_grad():
            return float(trainer.loss(
                trainer.dit_params, batch.video[0], batch.actions[0],
                torch.Generator().manual_seed(11))[0])

    first = fixed_loss()
    for _ in range(6):
        m = trainer.train_step_sync(batch)
        assert all(np.isfinite(v) for v in m.values())
        assert m["step_time_s"] > 0 and "mfu" not in m  # no CPU peak
    assert fixed_loss() < first
    moved = [not torch.equal(before[p], t) for p, t in
             leaves(trainer.dit_params) if toptim.decays(p)]
    assert all(moved)
    assert trainer.optimizer.count == 6


def test_callbacks_in_step_order_with_labels(tmp_path):
    """The deferred-metrics loop delivers one record and one callback per
    step, in step order and labelled, across the flush at each validation
    (gtax delivered two steps out of order there; ADVICE.md)."""
    trainer = _tiny_trainer(tmp_path, max_steps=5, validation_steps=2,
                            validation_max_batches=1)
    ds = DummyDataset("train", return_actions=True, height=48, width=64,
                      size=12)
    val = DataLoader(DummyDataset("validation", return_actions=True,
                                  height=48, width=64), 2, shuffle=False)
    seen = []
    trainer.training_loop(DataLoader(ds, 2, seed=0), val,
                          callbacks=[lambda tr, m: seen.append(m["step"])])
    assert trainer.global_step == 5
    assert seen == [1, 2, 3, 4, 5]
    path = tmp_path / "dit_metrics.jsonl"
    recs = [json.loads(line) for line in open(path)]
    steps = [r["step"] for r in recs if "train_loss" in r]
    assert steps == [1, 2, 3, 4, 5]
    assert sum("val_loss" in r for r in recs) == 3  # step 0, 2, 4
    assert all(r["step_time_s"] > 0 for r in recs if "train_loss" in r)


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_train_cli_runs_on_cpu(tmp_path, fmt):
    """python -m gtax_torch.cli.train <cfg> --device cpu on the debug
    presets: two steps of two accumulated micro-batches, one record each."""
    from gtax_torch.cli import train as cli

    cfg = dict(vae_checkpoint="", dataset_type="dummy",
               dit_model="DiT-debug", vae_model="vae-debug", batch_size=2,
               validation_batch_size=2, num_epochs=1, max_steps=2,
               gradient_accumulation_steps=2, learning_rate=1e-3,
               use_wandb=False, output_dir=str(tmp_path / "out"),
               ddim_noise_steps=8, ctx_max_noise_idx=3, n_prompt_frames=4,
               validation_steps=0, validation_max_batches=1, logging_steps=1,
               save_every=0, compute_dtype="float32",
               attention_backend="fused_all", model_name="dbg")
    path = tmp_path / f"cfg.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps(cfg))
    else:
        path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                                for k, v in cfg.items()))
    trainer = cli.main([str(path), "--dummy_size", "8", "--device", "cpu"])
    assert trainer.global_step == 2 and trainer.optimizer.count == 2
    recs = [json.loads(line) for line in open(
        tmp_path / "out" / "dbg_metrics.jsonl")]
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2]
