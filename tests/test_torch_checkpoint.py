"""The port's weight export, checkpoints, resume, evals and profile window
on the CPU, against gtax where gtax has the function.

The safetensors writers against gtax's (`dit_to_torch`, `vae_to_torch`,
`expected_dit_keys`, files read across both packages): bit-equal, both
sides only move and transpose fp32 values. Save -> resume -> continue
against an uninterrupted run of the port's Trainer (fp32, plain
versions): bit-equal in the losses, every master, both moments (mu in
bf16, its dtype kept), the count and the learning rate, since both runs do
the same host arithmetic on the same values.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gtax.io import safetensors_port as jport
from gtax.models import dit as jdit
from gtax.models import vae as jvae
from gtax.utils import profiling as jprof
from gtax_torch.cli import export as export_cli
from gtax_torch.data.actions import actions_to_one_hot
from gtax_torch.data.dummy import DummyDataset
from gtax_torch.data.loader import DataLoader
from gtax_torch.io import safetensors_port as tport
from gtax_torch.models import dit as tdit
from gtax_torch.models import vae as tvae
from gtax_torch.models.vae import VAEConfig, vae_init
from gtax_torch.train import checkpoint as ckpt
from gtax_torch.train.config import TrainingConfig
from gtax_torch.train.optim import leaves
from gtax_torch.train.trainer import Trainer
from gtax_torch.utils import profiling as tprof

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """The evals write debug_visualizations/ into the working directory."""
    monkeypatch.chdir(tmp_path)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gtax_dit():
    cfg = jdit.DiT_debug()
    tree = _np_tree(jdit.dit_init(jax.random.PRNGKey(0), cfg))
    r = np.random.default_rng(1)  # dit_init zeroes some leaves: fill all
    return cfg, jax.tree.map(
        lambda a: (r.standard_normal(a.shape) * 0.1).astype(np.float32),
        tree)


def _gtax_vae():
    cfg = jvae.VAE_debug()
    return cfg, _np_tree(jvae.vae_init(jax.random.PRNGKey(2), cfg))


# ------------------------------------------------------- weight export

@pytest.mark.parametrize("model", ["dit", "vae"])
def test_to_torch_matches_gtax(model):
    """The port's dit_to_torch / vae_to_torch of bridged gtax weights equal
    gtax's, key for key and bit for bit (fp32)."""
    if model == "dit":
        jcfg, tree = _gtax_dit()
        want = jport.dit_to_torch(tree, jcfg)
        got = tport.dit_to_torch(tport.dit_from_gtax(tree), tdit.DiT_debug())
    else:
        jcfg, tree = _gtax_vae()
        want = jport.vae_to_torch(tree, jcfg)
        got = tport.vae_to_torch(tport.vae_from_gtax(tree), tvae.VAE_debug())
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "gtax"])
def test_files_read_across_packages(tmp_path, writer):
    """A file the port writes, read by gtax's read_safetensors (the
    `safetensors` package), is bit-equal to what was written; a file gtax
    writes, read by the port, likewise."""
    jcfg, tree = _gtax_dit()
    want = jport.dit_to_torch(tree, jcfg)
    path = str(tmp_path / "dit.safetensors")
    if writer == "port":
        tport.save_dit(path, tport.dit_from_gtax(tree), tdit.DiT_debug())
        got = {k: np.asarray(v) for k, v in
               jport.read_safetensors(path).items()}
    else:
        jport.save_dit(path, tree, jcfg)
        got = {k: v.numpy() for k, v in tport.read_safetensors(path).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gtax_load_dit_of_port_save(tmp_path):
    """gtax's load_dit of the port's save_dit gives back gtax's tree."""
    jcfg, tree = _gtax_dit()
    path = str(tmp_path / "dit.safetensors")
    tport.save_dit(path, tport.dit_from_gtax(tree), tdit.DiT_debug())
    back = jport.load_dit(path, jcfg, verbose=False)
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path_, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path_]), leaf)


@pytest.mark.parametrize("preset", ["DiT-debug", "DiT-S/2"])
def test_expected_dit_keys_match_gtax(preset):
    assert (tport.expected_dit_keys(tdit.DiT_MODELS[preset]())
            == jport.expected_dit_keys(jdit.DiT_MODELS[preset]()))


def test_writer_keeps_every_dtype(tmp_path):
    """write_safetensors -> iter_safetensors keeps dtype, shape and bits
    (bf16, int8, uint8, bool, a scalar, an empty tensor), and the
    `safetensors` package reads the same file the same."""
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(3, 5, generator=g).bfloat16(),
               "q": torch.randint(-128, 127, (4, 2), dtype=torch.int8),
               "u": torch.arange(7, dtype=torch.uint8),
               "m": torch.tensor([True, False, True]),
               "s": torch.tensor(2.5), "e": torch.zeros(0, 4),
               "n": np.arange(6, dtype=np.int64).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    tport.write_safetensors(path, tensors)
    for back in (dict(tport.iter_safetensors(path)), load_file(path)):
        assert set(back) == set(tensors)
        for k, v in tensors.items():
            v = torch.as_tensor(v)
            assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
            assert torch.equal(back[k], v), k
    assert tport.read_safetensors(path)["w"].dtype == torch.float32


# --------------------------------------------------- trainer checkpoints

TINY_DIT = tdit.DiTConfig(input_h=6, input_w=8, patch_size=2, in_channels=4,
                          hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0,
                          external_cond_dim=25, max_frames=5)
TINY_VAE = VAEConfig(latent_dim=4, input_height=48, input_width=64,
                     patch_size=8, enc_dim=32, enc_depth=1, enc_heads=2,
                     dec_dim=32, dec_depth=1, dec_heads=2, mlp_ratio=2.0)


class _Clips:
    """Map-style clips that identify their index: every sample differs."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(100 + int(i))
        return {"video": r.random((5, 3, 48, 64), np.float32),
                "actions": actions_to_one_hot(r.integers(-1, 25, 5))}


def _trainer(out, **overrides):
    cfg = dict(dataset_type="dummy", batch_size=2, validation_batch_size=2,
               num_epochs=1, max_steps=4, gradient_accumulation_steps=1,
               ddim_noise_steps=8, ddim_noise_steps_inference=3,
               ctx_max_noise_idx=3, n_prompt_frames=4, use_wandb=False,
               learning_rate=1e-3, min_learning_rate=1e-4, warmup_ratio=0.25,
               weight_decay=0.01, output_dir=str(out),
               compute_dtype="float32", validation_steps=0, save_every=2,
               logging_steps=1, attention_backend="fused_all", mu_bf16=True,
               model_name="tiny")
    cfg.update(overrides)
    gen = torch.Generator().manual_seed(0)
    params = tdit.dit_init(TINY_DIT, gen)
    r = np.random.default_rng(3)  # nonzero adaLN heads: every leaf learns
    for _, p in leaves(params):
        if not p.any() and p.dim() == 2:
            p.copy_(torch.from_numpy(
                r.standard_normal(tuple(p.shape)).astype(np.float32) * 0.02))
    return Trainer(TrainingConfig.from_dict(cfg), total_dataset_size=12,
                   dit_cfg=TINY_DIT, vae_cfg=TINY_VAE, dit_params=params,
                   vae_params=vae_init(TINY_VAE, gen), device="cpu")


class _Crash(Exception):
    pass


def _run(trainer, crash_at=None):
    """Run the loop over _Clips(12); returns ({step: record}, [the batches'
    sums in dispatch order])."""
    records, batches = {}, []
    dispatch = trainer._dispatch

    def record(b):
        batches.append(float(b.video.sum()))
        return dispatch(b)

    trainer._dispatch = record

    def cb(tr, m):
        if m["step"] == crash_at:
            raise _Crash
        records[m["step"]] = m

    try:
        trainer.training_loop(DataLoader(_Clips(12), 2, seed=7), None,
                              callbacks=[cb])
    except _Crash:
        pass
    return records, batches


def _state(trainer):
    opt = trainer.optimizer.state_dict()
    return ({k: v.detach().clone() for k, v in
             ckpt.flat(trainer.dit_params).items()},
            {k: v.clone() for k, v in opt["mu"].items()},
            {k: v.clone() for k, v in opt["nu"].items()}, opt["count"])


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Save at step 2, the process dies after step 3, a new trainer
    resumes and runs steps 3-4: losses, grad norms and learning rates of
    steps 3-4, every master, mu (bf16), nu and the count equal an
    uninterrupted 4-step run's, bit for bit; the replayed batches are the
    same batches."""
    whole = _trainer(tmp_path / "a")
    rec_a, batches_a = _run(whole)
    assert sorted(rec_a) == [1, 2, 3, 4]

    first = _trainer(tmp_path / "b")
    _run(first, crash_at=3)
    with open(ckpt.ckpt_dir(str(tmp_path / "b"), "tiny") + "/step.json") as f:
        assert json.load(f)["step"] == 2
    resumed = _trainer(tmp_path / "b")
    rec_b, batches_b = _run(resumed)
    assert resumed.skip_batches == 2 and resumed.global_step == 4
    assert sorted(rec_b) == [3, 4]
    assert batches_b == batches_a[2:]
    for step in (3, 4):
        for key in ("train_loss", "grad_norm", "learning_rate"):
            assert rec_b[step][key] == rec_a[step][key], (step, key)
    params_a, mu_a, nu_a, count_a = _state(whole)
    params_b, mu_b, nu_b, count_b = _state(resumed)
    assert count_a == count_b == 4
    for want, got in ((params_a, params_b), (mu_a, mu_b), (nu_a, nu_b)):
        assert set(want) == set(got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    assert all(m.dtype == torch.bfloat16 for m in mu_b.values())
    # the masters were loaded in place: the optimizer updates what the
    # trainer reads
    assert all(a is b for a, (_, b) in zip(resumed.optimizer.params,
                                           leaves(resumed.dit_params)))


def test_step_json_pruning_and_export_files(tmp_path):
    """step.json carries gtax's keys; superseded state_* directories are
    pruned; each save writes the weight export under gtax's name."""
    trainer = _trainer(tmp_path)
    trainer.wandb_run_id = "run-1"
    _run(trainer)
    path = ckpt.ckpt_dir(str(tmp_path), "tiny")
    with open(os.path.join(path, "step.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"step", "epoch", "time", "wandb_run_id"}
    assert meta["step"] == 4 and meta["epoch"] == 0
    assert meta["wandb_run_id"] == "run-1"
    assert sorted(os.listdir(path)) == ["state_4", "step.json"]
    assert sorted(os.listdir(os.path.join(path, "state_4"))) == [
        ckpt.META, ckpt.STATE]
    for step in (2, 4):
        assert (tmp_path / f"tiny_epoch_1_{step}.safetensors").exists()
    # the cursor of a streaming dataset goes into step.json
    trainer.train_dataset = type("Stream", (), {"cursor": [1, 2, 3]})()
    trainer.save_checkpoint(0)
    with open(os.path.join(path, "step.json")) as f:
        assert json.load(f)["data_cursor"] == [1, 2, 3]


def test_callbacks_in_order_across_saves(tmp_path):
    """With save_every=2 every step's callback arrives once, in order 1,
    2, 3, 4, labelled (gtax delivered 2, 1, 4, 3 at its save points)."""
    seen = []
    trainer = _trainer(tmp_path)
    trainer.training_loop(DataLoader(_Clips(12), 2, seed=7), None,
                          callbacks=[lambda tr, m: seen.append(m["step"])])
    assert seen == [1, 2, 3, 4]


def test_resume_at_the_end_of_an_epoch_starts_the_next(tmp_path):
    """A state saved at an epoch's last step resumes at the next epoch with
    nothing skipped (gtax replayed the finished epoch whole): 12 clips, B=2
    -> 6 steps an epoch, 2 epochs."""
    kw = dict(num_epochs=2, max_steps=-1, save_every=6)
    first = _trainer(tmp_path, **kw)
    _run(first, crash_at=7)
    resumed = _trainer(tmp_path, **kw)
    rec, _ = _run(resumed)
    assert (resumed.start_epoch, resumed.skip_batches) == (2, 0)
    assert sorted(rec) == list(range(7, 13))
    assert resumed.global_step == 12


def test_resume_refuses_another_model(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.save_checkpoint(0)
    other = _trainer(tmp_path)
    other.dit_params["final"]["linear"]["bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="does not match"):
        other.try_resume()


def test_export_cli_round_trip(tmp_path):
    """python -m gtax_torch.cli.export on a trainer's checkpoint (DiT-debug,
    by step.json, --step and a state dir): the file holds the masters,
    bit-equal through the port's load_dit and gtax's."""
    cfg = dict(vae_checkpoint="", dataset_type="dummy", dit_model="DiT-debug",
               vae_model="vae-debug", use_wandb=False,
               output_dir=str(tmp_path), compute_dtype="float32",
               attention_backend="fused_all", model_name="dbg")
    trainer = Trainer(TrainingConfig.from_dict(cfg), total_dataset_size=8,
                      device="cpu")
    trainer.global_step = 5
    trainer.save_checkpoint(0)
    last = ckpt.ckpt_dir(str(tmp_path), "dbg")
    want = tport.dit_to_torch(trainer.dit_params, trainer.dit_cfg)
    for i, args in enumerate(([last], [last, "--step", "5"],
                              [os.path.join(last, "state_5")])):
        out = str(tmp_path / f"e{i}.safetensors")
        export_cli.main(args + ["--out", out, "--dit_model", "DiT-debug"])
        back = dict(leaves(tport.load_dit(out, tdit.DiT_debug(),
                                          verbose=False)))
        masters = dict(leaves(trainer.dit_params))
        assert set(back) == set(masters)
        for path, b in masters.items():
            assert torch.equal(back[path], b.detach()), path
        jback = jport.read_safetensors(out)
        for k, v in want.items():
            np.testing.assert_array_equal(jback[k], v.numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError):
        export_cli.main([last, "--step", "6", "--out", str(tmp_path / "x")])


def test_optimizer_state_dict_round_trip(tmp_path):
    """AdamW.load_state_dict copies into its own moments in place, keeps
    their dtypes, takes the count, and refuses a dtype change."""
    trainer = _trainer(tmp_path)
    opt = trainer.optimizer
    sd = opt.state_dict()
    mu0 = list(opt.mu)
    new = {"count": 7,
           "mu": {k: torch.full_like(v, 0.5) for k, v in sd["mu"].items()},
           "nu": {k: torch.full_like(v, 0.25) for k, v in sd["nu"].items()}}
    opt.load_state_dict(new)
    assert opt.count == 7 and all(a is b for a, b in zip(opt.mu, mu0))
    assert all(m.dtype == torch.bfloat16 and bool((m == 0.5).all())
               for m in opt.mu)
    new["mu"] = {k: v.float() for k, v in new["mu"].items()}
    with pytest.raises(ValueError, match="want torch.bfloat16"):
        opt.load_state_dict(new)


# ----------------------------------------------------------------- evals

def _eval_batch():
    ds = DummyDataset("validation", return_actions=True, height=48,
                      width=64)
    return next(iter(DataLoader(ds, 2, shuffle=False)))


def test_predict_evals_write_files_and_leave_the_generator(tmp_path):
    """predict writes the rollout mp4 and predict_noise the renoise grid
    under debug_visualizations/, on the CPU; neither advances the training
    generator; predict_frames returns the decoded uint8 frames."""
    trainer = _trainer(tmp_path / "out")
    state = trainer.generator.get_state()
    batch = _eval_batch()
    frames = trainer.predict_frames(batch, num_frames=6)
    assert frames.shape == (6, 48, 64, 3) and frames.dtype == np.uint8
    path = trainer.predict(batch, num_frames=6)
    assert path == "debug_visualizations/test_tiny_0_epoch_0_gs_0.mp4"
    assert os.path.getsize(path) > 0
    denoised = trainer.predict_noise(batch)
    assert denoised.shape == (1, 5, 4, 6, 8)
    assert torch.isfinite(denoised).all()
    assert os.path.getsize("debug_visualizations/tiny_noise_gs_0.png") > 0
    assert torch.equal(trainer.generator.get_state(), state)
    # the same eval key at the same step: the same frames
    np.testing.assert_array_equal(trainer.predict_frames(batch, 6), frames)


def test_validation_runs_the_evals(tmp_path, monkeypatch):
    """run_validation computes the eval loss, then predict and
    predict_noise on the first batch; a failing eval is logged, not
    raised."""
    trainer = _trainer(tmp_path / "out")
    calls = []
    monkeypatch.setattr(trainer, "predict",
                        lambda b: calls.append(("predict", b.video.shape)))

    def broken(b):
        calls.append(("noise", b.video.shape))
        raise RuntimeError("eval exploded")

    monkeypatch.setattr(trainer, "predict_noise", broken)
    val = DataLoader(DummyDataset("validation", return_actions=True,
                                  height=48, width=64), 2, shuffle=False)
    loss = trainer.run_validation(val, max_batches=2)
    assert np.isfinite(loss)
    assert calls == [("predict", (2, 5, 3, 48, 64)),
                     ("noise", (2, 5, 3, 48, 64))]


# --------------------------------------------------------------- profiling

def test_profile_window_closes_when_the_run_ends_inside_it(tmp_path):
    """profile_dir traces steps restart+3 .. restart+12; a run that ends
    at max_steps=5, inside that window, still writes a closed Chrome
    trace (gtax left it open, ADVICE.md)."""
    prof = tmp_path / "prof"
    trainer = _trainer(tmp_path, max_steps=5, save_every=0,
                       profile_dir=str(prof))
    trainer.training_loop(DataLoader(_Clips(12), 2, seed=7), None)
    assert trainer.global_step == 5
    with open(prof / "trace_step_3.json") as f:
        events = json.load(f)["traceEvents"]
    assert events


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_matches_gtax(monkeypatch, warmup):
    """StepTimer's recorded times, mean and best equal gtax's over the
    same clock readings."""
    import time

    ticks = [0.0, 1.0, 1.5, 3.5, 4.0, 4.25, 10.0, 10.125]

    def run(cls):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls(warmup=warmup)
        dts = []
        for _ in range(len(ticks) // 2):
            timer.start()
            dts.append(timer.stop())
        return dts, timer.times, timer.mean, timer.best

    assert run(tprof.StepTimer) == run(jprof.StepTimer)


def test_trace_is_a_noop_without_a_dir():
    with tprof.trace(None) as prof:
        assert prof is None
