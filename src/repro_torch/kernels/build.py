"""Build a CUDA source into a shared library at first use and load it
with ``ctypes``.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas -v`` turns each kernel's ``csrc/*.cu`` (plain C
interface, no PyTorch headers, so it builds in seconds) into
``lib<name>.so`` under ``kernels/_build/<name>-<hash of the sources, the
headers they include and the flags>/``, with what ``ptxas -v`` said of
each kernel (registers, spills) in ``ptxas.log`` beside it
(``ptxas_log``). The hash keys the cache: an edited source or header
(``kernels/csrc/hopper.cuh``, which the bf16 kernels include) builds
anew, an unchanged one loads the library already there. A file lock
around the build makes concurrent first calls (threads or processes)
build once; ``build_all`` starts one ``nvcc`` per library, all at once.
Nothing here runs at import time: a CPU-only machine imports every
module and never builds.

``LaunchCounter`` is what each binding counts its launches with.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class LaunchCounter:
    """Launches of one kernel, by shape. Thread-safe: the serving flush
    worker and the caller's thread both launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_shape: dict[tuple, int] = {}

    def add(self, shape: tuple) -> None:
        with self._lock:
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.by_shape.values())

    def reset(self) -> None:
        with self._lock:
            self.by_shape = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: building a CUDA kernel needs the "
                           "CUDA toolkit (nvcc on PATH or under "
                           "/usr/local/cuda/bin)")
    return path


def with_headers(sources: list[Path]) -> list[Path]:
    """The sources and every file they include by a quoted path (found
    beside the including file), each once, in the order first met."""
    seen: list[Path] = []

    def visit(path: Path) -> None:
        path = path.resolve()
        if path in seen:
            return
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (path.parent / inc).is_file():
                visit(path.parent / inc)

    for src in sources:
        visit(Path(src))
    return seen


def library_path(name: str, sources: list[Path]) -> Path:
    """Where ``name``'s library for these exact sources, the headers
    they include and the flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in with_headers(sources):
        digest.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def ptxas_log(name: str, sources: list[Path]) -> Path:
    """Where ``build`` keeps nvcc's output (``ptxas -v``'s lines) for
    ``name``'s library."""
    return library_path(name, sources).parent / "ptxas.log"


def build(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>.so`` unless a library for
    these exact sources is already built; returns its path."""
    lib = library_path(name, sources)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       *map(str, sources)]
                done = subprocess.run(cmd, capture_output=True, text=True)
                if done.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name} ({done.returncode}):\n"
                        f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
                ptxas_log(name, sources).write_text(done.stdout
                                                    + done.stderr)
                os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def load(name: str, sources: list[Path]) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if needed), once per
    process."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name, sources)))
                _loaded[name] = lib
    return lib


def build_all(libraries: dict[str, list[Path]]) -> dict[str, Path]:
    """Build every ``name -> sources`` library not built yet, one
    ``nvcc`` each, all started together; returns their paths."""
    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        futures = {name: pool.submit(build, name, sources)
                   for name, sources in libraries.items()}
        return {name: f.result() for name, f in futures.items()}
