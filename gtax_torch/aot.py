"""Ahead-of-time kernel library: build once, start without nvcc
(counterpart of gtax/aot.py).

gtax serializes each compiled XLA executable, because its first compile
of the serving layout takes minutes. In the port the artifact that is slow
to make is the kernel library, the nvcc build of gtax_torch/csrc/*.cu
(gtax_torch.kernels.build); there is no per-shape executable. So
AotCache(dir) keeps gtax's contract for that artifact:

- key: everything that invalidates the library: the sources and flags
  (build.source_digest), the card's compute capability, and `nvcc
  --version`. The file is <sources+card>-<nvcc>.so. A process without
  nvcc cannot read the toolchain's version, and cannot build either: it
  takes the newest artifact of these sources for this card, whichever nvcc
  made it;
- load or build: load_or_compile loads the key's artifact when there is
  one; otherwise it builds it and writes it through a temporary file and
  os.replace;
- events: gtax's `compile`, `save`, `load`, `load_failed` and
  `save_failed`, newest last, in `events`;
- a bad artifact: one that fails to load is rebuilt and overwritten,
  never skipped; with no nvcc to rebuild it, load_or_compile raises.

Differences by design: gtax keys each executable by the ServingConfig
(its `_aot_tag`) and the call's signature, while the library depends on
neither; and serving's prewarm captures no CUDA graph (none is captured
anywhere yet).

TRUST: loading a .so with ctypes runs its code, as gtax's unpickling of an
artifact does: aot_dir must be a private, trusted directory. It is created
owner-only (0o700).
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gtax_torch.kernels import build


class KernelLibrary:
    """How the kernel library is keyed, built and loaded: the nvcc build of
    gtax_torch.kernels.build on this process's card. Tests on the CPU
    inject a stand-in with the same methods."""

    def sources(self) -> str:
        return build.source_digest()

    def target(self) -> str:
        major, minor = torch.cuda.get_device_capability()
        return f"sm_{major}{minor}"

    def toolchain(self) -> str | None:
        """`nvcc --version` (None without nvcc)."""
        nvcc = build.find_nvcc()
        if nvcc is None:
            return None
        return subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout

    def build(self, out: Path) -> None:
        build.build(out=out)

    def load(self, path: Path):
        return build.load_library(path)


def _hash(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


class AotCache:
    """A directory of built kernel libraries, one file per key."""

    def __init__(self, cache_dir: str, library: KernelLibrary | None = None):
        self.dir = cache_dir
        # TRUST ASSUMPTION (module docstring): a library is code that runs
        # when it is loaded; the directory is the owner's alone
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
        self.library = library or KernelLibrary()
        # load / compile / save events of this process, newest last
        self.events: list[tuple[str, str]] = []

    def key(self) -> tuple[str, str | None]:
        """(the sources' and the card's part, the toolchain's part or None
        without nvcc)."""
        b = self.library
        tool = b.toolchain()
        return (_hash(b.sources(), b.target()),
                None if tool is None else _hash(tool))

    def path(self) -> str | None:
        """The artifact of this process's key (with no toolchain: the
        newest one of these sources for this card, or None)."""
        base, tool = self.key()
        if tool is not None:
            return os.path.join(self.dir, f"{base}-{tool}.so")
        found = glob.glob(os.path.join(self.dir, f"{base}-*.so"))
        return max(found, key=os.path.getmtime) if found else None

    def load_or_compile(self):
        """The loaded library: the key's artifact, else a fresh build saved
        as it."""
        path = self.path()
        if path is not None and os.path.exists(path):
            try:
                lib = self.library.load(Path(path))
                self.events.append(("load", path))
                return lib
            except Exception as e:  # another toolchain's, or a corrupt file
                self.events.append(("load_failed", f"{path}: {e!r}"))
        base, tool = self.key()
        if tool is None:
            raise RuntimeError(
                f"{self.dir}: no loadable kernel library for these sources "
                "on this card, and no nvcc to build one")
        path = os.path.join(self.dir, f"{base}-{tool}.so")
        work = tempfile.mkdtemp(prefix="build-", dir=self.dir)
        try:
            tmp = Path(work) / build.LIB_NAME
            self.library.build(tmp)
            self.events.append(("compile", path))
            try:
                os.replace(tmp, path)  # atomic: a reader sees all or none
                self.events.append(("save", path))
            except OSError as e:
                self.events.append(("save_failed", repr(e)))
                path = tmp
            return self.library.load(Path(path))
        finally:  # a loaded library stays mapped once its file is gone
            shutil.rmtree(work, ignore_errors=True)
