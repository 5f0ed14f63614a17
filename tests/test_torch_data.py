"""The port's data backends against gtax's on the CPU: the clip decode and
transform, the tar streamer (on tars the tests build), the latent cache,
the HF row mapping, the threaded DataLoader and build_loaders' wiring.

Both packages decode with the same libraries (cv2, PIL) and do the same
host arithmetic, so every comparison is bit-equal, with one exception
stated at its test: the latent cache's latents, encoded by each package's
VAE in bf16 (2**-7 of the largest latent, as
test_torch_train.py::test_trainer_encode_matches_gtax_unfused_vae).
"""

import io
import json
import tarfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtax.data import common as jcommon
from gtax.data import hf as jhf
from gtax.data import latents as jlatents
from gtax.data import loader as jloader
from gtax.data import webtar as jwebtar
from gtax.models import vae as jvae
from gtax.train import config as jconfig
from gtax.train import trainer as jtrainer
from gtax_torch.data import common as tcommon
from gtax_torch.data import hf as thf
from gtax_torch.data import latents as tlatents
from gtax_torch.data import loader as tloader
from gtax_torch.data import webtar as twebtar
from gtax_torch.io.safetensors_port import vae_from_gtax
from gtax_torch.train import trainer as ttrainer
from gtax_torch.train.config import TrainingConfig

torch.set_num_threads(2)

H, W = 36, 64  # the clips' target size in these tests


def _jpeg(strip):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(strip).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _strip(i, h=27, w=48):
    """A 5-frame strip with structure (JPEG and resize have work to do)."""
    r = np.random.default_rng(i)
    base = r.integers(0, 256, (h // 3 + 1, 5 * w // 3 + 1, 3), np.uint8)
    return np.kron(base, np.ones((3, 3, 1), np.uint8))[:h, :5 * w]


def _shard(path, first, n, with_json=True):
    """A tar shard shaped like the GTA V dataset: strip jpg, cls, json."""
    with tarfile.open(path, "w") as tar:
        for i in range(first, first + n):
            members = {"jpg": _jpeg(_strip(i)), "cls": str(i % 3).encode()}
            if with_json:
                members["json"] = json.dumps(
                    {"actions_int": [(i + k) % 26 - 1 for k in range(5)]}
                ).encode()
            for ext, data in members.items():
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


@pytest.fixture
def shards(tmp_path):
    paths = []
    for s in range(4):
        path = str(tmp_path / f"{s:05d}.tar")
        _shard(path, 10 * s, 3 + s % 2)
        paths.append(path)
    return paths


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("size", [(36, 64), (360, 640), (20, 30)])
def test_decode_strip_clip_u8_matches_gtax(size):
    data = _jpeg(_strip(5))
    got = tcommon.decode_strip_clip_u8(data, 5, *size)
    want = jcommon.decode_strip_clip_u8(data, 5, *size)
    assert got.dtype == np.uint8 and got.shape == (5, *size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_clip_transform_and_resize_match_gtax(dtype):
    strip = _strip(7, h=54, w=96)
    got = tcommon.ClipTransform(target_h=H, target_w=W)(strip)
    want = jcommon.ClipTransform(target_h=H, target_w=W)(strip)
    assert got.shape == (5, 3, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    frame = strip[:, :96].astype(dtype) / (255 if dtype == np.float32 else 1)
    np.testing.assert_array_equal(tcommon._resize_frame(frame, 20, 33),
                                  jcommon._resize_frame(frame, 20, 33))
    assert tcommon.split_len("train") == jcommon.split_len("train")


# ----------------------------------------------------------- tar stream

STREAMS = {
    "in order": dict(shuffle_shards=False, shuffle_buffer=1,
                     resampled=False),
    "shuffled": dict(shuffle_shards=True, shuffle_buffer=4, resampled=False,
                     seed=3),
    "worker 1 of 3": dict(worker_index=1, num_workers=3, shuffle_buffer=2,
                          resampled=False, seed=1),
    "decode pool": dict(decode_workers=3, shuffle_buffer=3, resampled=False,
                        seed=2),
    "pixel_u8": dict(pixel_u8=True, decode_workers=2, shuffle_buffer=1,
                     shuffle_shards=False, resampled=False),
    "resampled": dict(resampled=True, shuffle_buffer=3, seed=4),
}


def _take(ds, n):
    """n items with the cursor after each."""
    out, it = [], iter(ds)
    for item in it:
        out.append((item, list(ds.cursor)))
        if len(out) == n:
            break
    it.close()
    return out


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("actions", [True, False])
def test_webtar_stream_and_cursor_match_gtax(shards, name, actions):
    """Sample for sample, with the cursor after each: shard shuffling, the
    buffer, the worker split, the decode pool, pixel_u8, and a resampled
    stream into its second epoch."""
    kw = dict(split="train", return_actions=actions, shards=shards,
              transform=tcommon.ClipTransform(target_h=H, target_w=W),
              **STREAMS[name])
    jkw = dict(kw, transform=jcommon.ClipTransform(target_h=H, target_w=W))
    n = 20 if kw["resampled"] else 100
    got = _take(twebtar.WebTarDataset(**kw), n)
    want = _take(jwebtar.WebTarDataset(**jkw), n)
    assert len(got) == len(want) > 0
    for (a, ca), (b, cb) in zip(got, want):
        _same(a, b)
        assert ca == cb
    if kw["resampled"]:
        assert got[-1][1][0] >= 1  # into the second epoch


@pytest.mark.parametrize("cursor", [[0, 1, 2], [0, 2, 0], [1, 0, 1]])
def test_webtar_resume_from_cursor_matches_gtax(shards, cursor):
    """A stream restored at a mid-shard cursor yields gtax's continuation,
    and the samples an uninterrupted stream yields after that point."""
    kw = dict(split="train", return_actions=True, shards=shards,
              shuffle_shards=True, shuffle_buffer=1, resampled=True, seed=5,
              decode_workers=2)
    jkw = dict(kw, transform=jcommon.ClipTransform(target_h=H, target_w=W))
    kw["transform"] = tcommon.ClipTransform(target_h=H, target_w=W)
    whole = _take(twebtar.WebTarDataset(**kw), 30)
    ds, jds = twebtar.WebTarDataset(**kw), jwebtar.WebTarDataset(**jkw)
    ds.cursor, jds.cursor = list(cursor), list(cursor)
    got, want = _take(ds, 8), _take(jds, 8)
    for (a, ca), (b, cb) in zip(got, want):
        _same(a, b)
        assert ca == cb
    at = next(i for i, (_, c) in enumerate(whole) if c[:2] == cursor[:2]
              and c[2] > cursor[2])
    for (a, _), (b, _) in zip(got, whole[at:]):
        _same(a, b)


def test_webtar_pool_error_propagates(shards, monkeypatch):
    """A RuntimeError from the decode pool that is not its shutdown reaches
    the consumer (gtax ended the stream quietly, ADVICE.md); a shutdown
    still ends the stream."""
    from concurrent.futures import ThreadPoolExecutor

    kw = dict(split="train", return_actions=False, shards=shards,
              shuffle_buffer=1, resampled=False, decode_workers=2,
              transform=tcommon.ClipTransform(target_h=H, target_w=W))

    def refuse(self, *a, **k):
        raise RuntimeError("decoder pool is wedged")

    monkeypatch.setattr(ThreadPoolExecutor, "submit", refuse)
    with pytest.raises(RuntimeError, match="wedged"):
        list(twebtar.WebTarDataset(**kw))

    def closing(self, *a, **k):
        raise RuntimeError("cannot schedule new futures after shutdown")

    monkeypatch.setattr(ThreadPoolExecutor, "submit", closing)
    assert list(twebtar.WebTarDataset(**kw)) == []


def test_webtar_bad_shard_is_skipped(shards, tmp_path):
    """A shard that cannot be read is skipped with a message, as gtax and
    webdataset's warn_and_continue do."""
    bad = str(tmp_path / "bad.tar")
    with open(bad, "wb") as f:
        f.write(b"not a tar")
    kw = dict(split="train", return_actions=False, shuffle_shards=False,
              shuffle_buffer=1, resampled=False,
              transform=tcommon.ClipTransform(target_h=H, target_w=W))
    got = list(twebtar.WebTarDataset(shards=[bad, shards[0]], **kw))
    assert len(got) == len(list(twebtar.WebTarDataset(shards=shards[:1],
                                                      **kw)))


@pytest.mark.parametrize("pixel_u8", [True, False])
def test_webtar_needs_a_jpeg_decoder(shards, monkeypatch, pixel_u8):
    """With no JPEG decoder importable, building the dataset raises
    ImportError (gtax's streamer failed every sample and, resampled, looped
    forever)."""
    import builtins

    real = builtins.__import__

    def no_decoders(name, *a, **k):
        if name.split(".")[0] in ("cv2", "PIL"):
            raise ImportError(f"no {name}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(ImportError, match="JPEG decoder"):
        twebtar.WebTarDataset(shards=shards, pixel_u8=pixel_u8)


def test_webtar_len_and_tar_grouping_match_gtax(shards):
    kw = dict(split="train", return_actions=False, shards=shards,
              resampled=False)
    assert len(twebtar.WebTarDataset(size=7, **kw)) == 7
    assert (len(twebtar.WebTarDataset(**kw))
            == len(jwebtar.WebTarDataset(**kw)) == 4000)
    with open(shards[1], "rb") as f:
        raw = list(twebtar.iter_tar_samples(f))
    with open(shards[1], "rb") as f:
        jraw = list(jwebtar.iter_tar_samples(f))
    assert raw == jraw
    for a, b in zip(raw, jraw):
        _same(*(({k: v for k, v in d.items() if k != "json"})
                for d in (twebtar.decode_sample(a), jwebtar.decode_sample(b))))


# ---------------------------------------------------------- latent cache

def _vae():
    jcfg = jvae.VAEConfig(latent_dim=4, input_height=H, input_width=W,
                          patch_size=4, enc_dim=32, enc_depth=1, enc_heads=2,
                          dec_dim=32, dec_depth=1, dec_heads=2, mlp_ratio=2.0)
    jp = jvae.vae_init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda l: l + 0.01 if l.ndim == 1 else l, jp)
    from gtax_torch.models.vae import VAEConfig

    tcfg = VAEConfig(**{f: getattr(jcfg, f) for f in (
        "latent_dim", "input_height", "input_width", "patch_size", "enc_dim",
        "enc_depth", "enc_heads", "dec_dim", "dec_depth", "dec_heads",
        "mlp_ratio")})
    return jcfg, jp, tcfg, vae_from_gtax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("pixel_u8", [False, True])
def test_latent_cache_build_matches_gtax(shards, tmp_path, pixel_u8):
    """LatentCacheDataset.build over the same tar stream (float clips, or
    uint8 ones): meta.json equal to gtax's, actions equal, latents within
    2**-7 of the largest (bf16, each package's unfused VAE encode)."""
    jcfg, jp, tcfg, tp = _vae()
    kw = dict(split="train", return_actions=True, shards=shards,
              shuffle_shards=False, shuffle_buffer=1, resampled=False,
              size=50, pixel_u8=pixel_u8)
    ds = twebtar.WebTarDataset(
        transform=tcommon.ClipTransform(target_h=H, target_w=W), **kw)
    jds = jwebtar.WebTarDataset(
        transform=jcommon.ClipTransform(target_h=H, target_w=W), **kw)
    got = tlatents.LatentCacheDataset.build(
        ds, tp, tcfg, str(tmp_path / "t"), encode_batch=3,
        compute_dtype=torch.bfloat16)
    want = jlatents.LatentCacheDataset.build(
        jds, jp, jcfg, str(tmp_path / "j"), encode_batch=3,
        compute_dtype=jnp.bfloat16)
    assert got.meta == want.meta and got.meta["n"] == 14
    assert len(got) == len(want) == 14
    ref = np.stack([want[i]["latents"] for i in range(14)])
    lat = np.stack([got[i]["latents"] for i in range(14)])
    np.testing.assert_allclose(lat, ref, rtol=0,
                               atol=2.0**-7 * np.abs(ref).max())
    for i in range(14):
        np.testing.assert_array_equal(got[i]["actions"], want[i]["actions"])


class _Clips:
    def __init__(self, n, h=48, w=64):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(50 + int(i))
        return {"video": r.random((5, 3, self.h, self.w), np.float32),
                "actions": r.random((5, 25)).astype(np.float32)}


def test_cached_training_is_bit_identical_to_pixel_training(tmp_path):
    """Two steps from a latent cache (built with the trainer's VAE,
    backend and batch) give the same losses and masters as two steps that
    encode the same clips on the fly, bit for bit (fp32, CPU)."""
    from gtax_torch.models import dit as tdit
    from gtax_torch.models.vae import VAEConfig, vae_init
    from gtax_torch.train.optim import leaves

    dcfg = tdit.DiTConfig(input_h=6, input_w=8, patch_size=2, in_channels=4,
                          hidden_size=32, depth=2, num_heads=2, mlp_ratio=2.0,
                          external_cond_dim=25, max_frames=5)
    vcfg = VAEConfig(latent_dim=4, input_height=48, input_width=64,
                     patch_size=8, enc_dim=32, enc_depth=1, enc_heads=2,
                     dec_dim=32, dec_depth=1, dec_heads=2, mlp_ratio=2.0)

    def trainer():
        g = torch.Generator().manual_seed(0)
        cfg = TrainingConfig.from_dict(dict(
            dataset_type="dummy", batch_size=2, max_steps=2, num_epochs=1,
            gradient_accumulation_steps=1, ddim_noise_steps=8,
            ctx_max_noise_idx=3, n_prompt_frames=4, use_wandb=False,
            output_dir=str(tmp_path / "out"), compute_dtype="float32",
            validation_steps=0, save_every=0, logging_steps=1,
            attention_backend="fused_all", resume_from_checkpoint=False))
        return ttrainer.Trainer(cfg, total_dataset_size=8, dit_cfg=dcfg,
                                vae_cfg=vcfg, dit_params=tdit.dit_init(dcfg, g),
                                vae_params=vae_init(vcfg, g), device="cpu")

    runs = []
    for cached in (False, True):
        tr = trainer()
        ds = _Clips(4)
        if cached:
            ds = tlatents.LatentCacheDataset.build(
                ds, tr.vae_params, tr.vae_cfg, str(tmp_path / "cache"),
                encode_batch=2, backend="fused_all")
        loader = tloader.DataLoader(ds, 2, shuffle=False)
        if cached:
            assert next(iter(loader)).is_latents
        losses = []
        tr.training_loop(loader, None,
                         callbacks=[lambda t, m: losses.append(
                             m["train_loss"])])
        runs.append((losses, [p.detach() for _, p in leaves(tr.dit_params)]))
    (l0, p0), (l1, p1) = runs
    assert len(l0) == 2 and l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ------------------------------------------------------------------ hf

def test_hf_row_mapping_matches_gtax(monkeypatch):
    """HFDataset over in-memory rows (load_dataset replaced; nothing is
    downloaded): the same clips and actions as gtax's, for PIL and numpy
    strips."""
    import datasets
    from PIL import Image

    rows = [{"jpg": Image.fromarray(_strip(i, 27, 48)) if i % 2
             else _strip(i, 27, 48),
             "json": {"actions_int": [i % 25, -1, 3, 24, 0]}}
            for i in range(3)]
    asked = []

    def load(repo, split):
        asked.append((repo, split))
        return rows

    monkeypatch.setattr(datasets, "load_dataset", load)
    for actions in (True, False):
        got = thf.HFDataset("validation", actions,
                            transform=tcommon.ClipTransform(target_h=H,
                                                            target_w=W))
        want = jhf.HFDataset("validation", actions,
                             transform=jcommon.ClipTransform(target_h=H,
                                                             target_w=W))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same(a, b)
    assert asked[0] == asked[1] == ("Iker/GTAV-Driving-Dataset",
                                    "validation")


# ---------------------------------------------------------------- loader

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"video": np.full((2,), float(i), np.float32),
                "actions": np.full((1,), float(-i), np.float32)}


def _batches(loader, epochs=2):
    return [[(b.video, b.actions, b.is_latents) for b in loader]
            for _ in range(epochs)]


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3), (2, 3), (3, 4)])
@pytest.mark.parametrize("workers,drop_last", [(1, True), (4, False)])
def test_dataloader_matches_gtax(rank, world, workers, drop_last):
    """The same batches as gtax's DataLoader for the same seed, epochs
    (set_epoch included), rank and world, and the same length."""
    kw = dict(batch_size=3, num_workers=workers, seed=11, rank=rank,
              world=world, drop_last=drop_last)
    got = tloader.DataLoader(_Indexed(17), **kw)
    want = jloader.DataLoader(_Indexed(17), **kw)
    assert len(got) == len(want)
    for loader in (got, want):
        loader.set_epoch(4)
    for eg, ew in zip(_batches(got), _batches(want)):
        assert len(eg) == len(ew) > 0
        for (v, a, l), (jv, ja, jl) in zip(eg, ew):
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(a, ja)
            assert l == jl is False
    assert got.epoch == want.epoch == 6


def test_dataloader_streams_match_gtax(shards):
    """An iterable dataset (the tar streamer's uint8 clips) batches as
    gtax's: uint8 kept, the last partial batch dropped."""
    kw = dict(split="train", return_actions=True, shards=shards,
              shuffle_buffer=1, resampled=False, pixel_u8=True,
              shuffle_shards=False)
    got = list(tloader.DataLoader(twebtar.WebTarDataset(
        transform=tcommon.ClipTransform(target_h=H, target_w=W), **kw), 4))
    want = list(jloader.DataLoader(jwebtar.WebTarDataset(
        transform=jcommon.ClipTransform(target_h=H, target_w=W), **kw), 4))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.video.dtype == np.uint8 and a.video.shape == (4, 5, H, W, 3)
        np.testing.assert_array_equal(a.video, b.video)
        np.testing.assert_array_equal(a.actions, b.actions)


class _Failing:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i >= 4:
            raise RuntimeError("decode exploded")
        return {"video": np.zeros((1,), np.float32)}


@pytest.mark.parametrize("workers", [1, 3])
def test_dataloader_errors_reach_the_consumer(workers):
    """A producer error is raised in the consumer after the batches before
    it, as gtax's loader does."""
    for cls in (tloader.DataLoader, jloader.DataLoader):
        loader = cls(_Failing(), 2, num_workers=workers, shuffle=False)
        seen = []
        with pytest.raises(RuntimeError, match="decode exploded"):
            for b in loader:
                seen.append(b.video.shape)
        assert seen == [(2, 1), (2, 1)]


def test_dataloader_early_exit_stops_the_producer():
    """A consumer that leaves with the queue full releases the producer
    thread."""
    before = threading.active_count()
    loader = tloader.DataLoader(_Indexed(64), 1, num_workers=2, prefetch=1)
    for _ in loader:
        break
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before


def test_make_dataset_backends(shards):
    assert isinstance(tloader.make_dataset("webdataset", "train", False,
                                           shards=shards),
                      twebtar.WebTarDataset)
    assert len(tloader.make_dataset("dummy", "validation", True)) == 10
    with pytest.raises(ValueError, match="Invalid dataset type"):
        tloader.make_dataset("nope", "train", False)


# ---------------------------------------------------------- build_loaders

class _Recorded:
    def __init__(self, calls, kind, split, actions, kw):
        calls.append((kind, split, actions, kw))

    def __len__(self):
        return 10

    def __getitem__(self, i):
        raise AssertionError("not read")


def _recorded_kw(module, monkeypatch, cfg, **kw):
    calls = []
    monkeypatch.setattr(module, "make_dataset",
                        lambda *a, **k: _Recorded(calls, *a, k))
    train, val = module.build_loaders(cfg, **kw)

    def plain(k):
        return {n: vars(v) if isinstance(v, (tcommon.ClipTransform,
                                             jcommon.ClipTransform)) else v
                for n, v in k.items()}

    return [(c[0], c[1], c[2], plain(c[3])) for c in calls], val


@pytest.mark.parametrize("vae_model", ["vae-debug",
                                       "vit-l-20-shallow-encoder"])
@pytest.mark.parametrize("kw", [
    {}, {"shards": ["a.tar"], "size": 40},
    {"shards": ["a.tar"], "val_shards": ["v.tar"], "size": 40,
     "val_size": 8, "decode_workers": 3}])
def test_build_loaders_webdataset_kwargs_match_gtax(monkeypatch, vae_model,
                                                    kw):
    """build_loaders hands make_dataset the same keyword arguments as
    gtax's (one process): pixel_u8, the decode pool, the VAE-size resize,
    the splits' shards and sizes, and a validation stream that is one
    unshuffled pass; the validation loader does not shuffle."""
    raw = dict(dataset_type="webdataset", vae_model=vae_model,
               batch_size=2, validation_batch_size=3)
    got, val = _recorded_kw(ttrainer, monkeypatch,
                            TrainingConfig.from_dict(raw), **dict(kw))
    want, jval = _recorded_kw(jtrainer, monkeypatch,
                              jconfig.TrainingConfig.from_dict(raw),
                              **dict(kw))
    assert got == want
    assert got[1][3]["resampled"] is False
    assert val.shuffle is jval.shuffle is False
    assert val.batch_size == jval.batch_size == 3


def test_train_cli_on_local_tars_with_a_latent_cache(tmp_path, monkeypatch):
    """python -m gtax_torch.cli.train with --dataset_root (the tar
    streamer, uint8 clips resized to the debug VAE), --dataset_size and
    --latent_cache on the CPU: the first run builds the cache, trains two
    steps from it, runs the evals on the pixel validation stream and saves;
    the second run reuses the cache and resumes from the checkpoint."""
    from gtax_torch.cli import train as cli

    monkeypatch.chdir(tmp_path)
    root = tmp_path / "shards"
    root.mkdir()
    for s in range(2):
        _shard(str(root / f"{s:05d}.tar"), 10 * s, 4)
    cfg = dict(vae_checkpoint="", dataset_type="webdataset",
               dit_model="DiT-debug", vae_model="vae-debug", batch_size=2,
               validation_batch_size=2, num_epochs=1, max_steps=2,
               gradient_accumulation_steps=1, use_wandb=False,
               output_dir=str(tmp_path / "out"), ddim_noise_steps=8,
               ddim_noise_steps_inference=2, ctx_max_noise_idx=3,
               n_prompt_frames=4, validation_steps=0,
               validation_max_batches=1, logging_steps=1, save_every=1,
               compute_dtype="float32", attention_backend="fused_all",
               model_name="dbg")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    args = [str(path), "--dataset_root", str(root), "--dataset_size", "8",
            "--latent_cache", str(tmp_path / "cache"), "--device", "cpu"]
    first = cli.main(args)
    assert first.global_step == 2
    assert json.loads((tmp_path / "cache" / "meta.json").read_text())["n"] == 8
    assert (tmp_path / "debug_visualizations"
            / "test_dbg_0_epoch_0_gs_0.mp4").exists()
    cfg["max_steps"] = 3
    path.write_text(json.dumps(cfg))
    second = cli.main(args)
    assert second.global_step == 3
    recs = [json.loads(line) for line in open(tmp_path / "out"
                                              / "dbg_metrics.jsonl")]
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3]
