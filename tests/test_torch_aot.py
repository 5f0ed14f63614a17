"""The port's AOT kernel-library cache (gtax_torch.aot) and serving's
aot_dir / prewarm: gtax's tests/test_aot.py contract, ported to the
artifact the port has (the nvcc-built kernel library, not a per-shape
executable).

There is no nvcc on the CPU, so the cache's library is a stand-in with
the real one's methods: it "builds" a file with a magic header and
"loads" only such a file (a corrupt artifact fails to load, as ctypes
fails on a bad .so). Pinned: the first use builds and saves, a fresh cache
loads without building, a corrupt artifact is rebuilt and overwritten
(load_failed, then compile), the key follows the sources, the card and
the toolchain (and with no toolchain the newest artifact of the sources
and card loads, or the call raises: nothing is skipped), the directory is
owner-only, and kernels/build.library() takes its library from the cache
in use. Serving: aot_dir is off by default (prewarm is then None, gtax's
no-op); with it, on the CPU the directory is made, nothing is built, and
prewarm runs encode, rollout and decode in a thread with gtax's events,
after which generate() is bit-equal to a cold generator's; the generate
CLI prewarms under --aot_dir.
"""

import os
import stat

import numpy as np
import pytest
import torch

from gtax_torch import aot
from gtax_torch import serving
from gtax_torch.kernels import build

torch.set_num_threads(2)

MAGIC = b"\x7fSTAND-IN"


class StandIn(aot.KernelLibrary):
    """The nvcc build's stand-in: counts its builds."""

    def __init__(self, tool="nvcc release 12.8", target="sm_90",
                 sources="sources-a"):
        self.tool, self._target, self._sources = tool, target, sources
        self.builds = 0

    def sources(self):
        return self._sources

    def target(self):
        return self._target

    def toolchain(self):
        return self.tool

    def build(self, out):
        self.builds += 1
        out.write_bytes(MAGIC + self._sources.encode())

    def load(self, path):
        data = path.read_bytes()
        if not data.startswith(MAGIC):
            raise OSError(f"{path}: invalid ELF header")
        return ("library", data)


def _kinds(cache):
    return [kind for kind, _ in cache.events]


def _artifacts(d):
    return sorted(p.name for p in d.glob("*.so"))


def test_aot_build_save_then_load(tmp_path):
    first = aot.AotCache(str(tmp_path), StandIn())
    lib = first.load_or_compile()
    assert _kinds(first) == ["compile", "save"]
    assert len(_artifacts(tmp_path)) == 1 and first.library.builds == 1
    # a fresh cache (a new process) loads, builds nothing
    second = aot.AotCache(str(tmp_path), StandIn())
    assert second.load_or_compile() == lib
    assert _kinds(second) == ["load"] and second.library.builds == 0
    # no temporary build directory is left behind
    assert [p.name for p in tmp_path.iterdir()] == _artifacts(tmp_path)


def test_aot_corrupt_artifact_is_rebuilt(tmp_path):
    aot.AotCache(str(tmp_path), StandIn()).load_or_compile()
    (path,) = tmp_path.glob("*.so")
    path.write_bytes(b"not a library")
    cache = aot.AotCache(str(tmp_path), StandIn())
    lib = cache.load_or_compile()
    assert _kinds(cache) == ["load_failed", "compile", "save"]
    assert lib[1].startswith(MAGIC) and path.read_bytes().startswith(MAGIC)
    assert _artifacts(tmp_path) == [path.name]


@pytest.mark.parametrize("change", ["sources", "target", "tool"])
def test_aot_key_follows_what_invalidates(tmp_path, change):
    aot.AotCache(str(tmp_path), StandIn()).load_or_compile()
    other = StandIn(**{change: "other"})
    cache = aot.AotCache(str(tmp_path), other)
    cache.load_or_compile()
    assert _kinds(cache) == ["compile", "save"]
    assert len(_artifacts(tmp_path)) == 2


def test_aot_without_a_toolchain(tmp_path):
    """No nvcc: the newest artifact of these sources for this card loads
    (whichever nvcc made it); none, or a corrupt one, raises: there is
    nothing to build with, and a bad artifact is never skipped."""
    none = aot.AotCache(str(tmp_path), StandIn(tool=None))
    with pytest.raises(RuntimeError, match="no nvcc"):
        none.load_or_compile()
    aot.AotCache(str(tmp_path), StandIn(tool="nvcc 12.4")).load_or_compile()
    cache = aot.AotCache(str(tmp_path), StandIn(tool=None))
    assert cache.load_or_compile()[1].startswith(MAGIC)
    assert _kinds(cache) == ["load"] and cache.library.builds == 0
    for p in tmp_path.glob("*.so"):
        p.write_bytes(b"truncated")
    cache = aot.AotCache(str(tmp_path), StandIn(tool=None))
    with pytest.raises(RuntimeError, match="no nvcc"):
        cache.load_or_compile()
    assert _kinds(cache) == ["load_failed"]


def test_aot_dir_is_owner_only(tmp_path):
    d = tmp_path / "aot"
    aot.AotCache(str(d), StandIn())
    assert stat.S_IMODE(os.stat(d).st_mode) == 0o700


def test_library_comes_from_the_cache_in_use(tmp_path):
    cache = aot.AotCache(str(tmp_path), StandIn())
    build.use_cache(cache)
    try:
        lib = build.library()
        assert lib[0] == "library" and build.library() is lib
        assert _kinds(cache) == ["compile", "save"]
    finally:
        build.use_cache(None)
    assert build._cache is None and build._lib is None


CFG = serving.ServingConfig(dtype="float32", noise_steps=3,
                            dit_model="DiT-debug", vae_model="vae-debug")


def _prompt(t0=2):
    return np.random.default_rng(0).random((1, t0, 3, 48, 64), np.float32)


def _gen(cfg):
    return serving.VideoGenerator.load("", "", cfg, device="cpu")


def test_aot_off_by_default():
    g = _gen(CFG)
    assert g._aot is None and g.prewarm(num_frames=4) is None


def test_prewarm_events_and_bit_equal_output(tmp_path):
    d = tmp_path / "aot"
    warm = _gen(serving.ServingConfig(**{**CFG.__dict__, "aot_dir": str(d)}))
    assert stat.S_IMODE(os.stat(d).st_mode) == 0o700
    t = warm.prewarm(num_frames=4, batch_size=1, n_prompt=2, wait=True)
    assert t is not None and not t.is_alive()
    assert _kinds(warm._aot) == ["prewarm_start", "prewarm_done"]
    assert not list(d.iterdir())  # nothing to build on the CPU
    out = warm.generate(_prompt(), num_frames=4, seed=3)
    np.testing.assert_array_equal(
        out, _gen(CFG).generate(_prompt(), num_frames=4, seed=3))


def test_prewarm_in_flight_serialises_with_generate(tmp_path):
    """generate() right after a prewarm that has not been joined waits for
    it on the generator's lock, and gives the cold generator's pixels."""
    g = _gen(serving.ServingConfig(**{**CFG.__dict__,
                                      "aot_dir": str(tmp_path)}))
    t = g.prewarm(num_frames=4, batch_size=1, n_prompt=2, use_actions=True)
    acts = np.zeros((1, 4, 25), np.float32)
    out = g.generate(_prompt(), acts, num_frames=4, seed=5)
    t.join(timeout=300)
    assert _kinds(g._aot) == ["prewarm_start", "prewarm_done"]
    np.testing.assert_array_equal(
        out, _gen(CFG).generate(_prompt(), acts, num_frames=4, seed=5))


def test_generate_cli_prewarms(tmp_path, monkeypatch):
    """--aot_dir: the CLI prewarms (and waits for it in generate); with
    --no_prewarm it does not; the video is written either way."""
    from PIL import Image

    from gtax_torch.cli import generate as cli

    png = tmp_path / "start.png"
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(png)
    calls = []
    real = serving.VideoGenerator.prewarm
    monkeypatch.setattr(serving.VideoGenerator, "prewarm",
                        lambda self, **kw: calls.append(kw) or real(self,
                                                                    **kw))
    for extra in ([], ["--no_prewarm"]):
        out = tmp_path / f"v{len(extra)}.mp4"
        cli.main(["--total-frames", "3", "--noise_steps", "2",
                  "--dit_model", "DiT-debug", "--vae_model", "vae-debug",
                  "--dit_model_path", "", "--vae_model_path", "",
                  "--start_frame", str(png), "--output_path", str(out),
                  "--dtype", "float32", "--device", "cpu", "--seed", "0",
                  "--aot_dir", str(tmp_path / "aot"), *extra])
        assert out.exists() and out.stat().st_size > 0
    assert calls == [{"num_frames": 3, "batch_size": 1, "n_prompt": 1,
                      "use_actions": False}]
