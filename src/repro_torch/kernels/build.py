"""Build and load the port's CUDA kernels.

Each source in ``registry.AUDITED_FILES`` compiles on first use into a
shared library with a plain C interface under ``build/`` at the root of the
checkout (listed in ``.gitignore``), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/lib<name>.so <source>

and loads with ``ctypes``.  A library newer than its source is reused.
``build_all`` starts one ``nvcc`` per stale source, all at once, and waits
for them; the compiler's output (``-Xptxas=-v``: registers, shared memory
and spills per kernel) is kept in ``LOG``.  Each build writes to a
``.<pid>.tmp`` file renamed over the library when it succeeds, so the
ranks of a fleet that find a source stale at once never write the same
path, nor load a half-written library.  Nothing here runs at import.
``set_build_dir`` moves the libraries elsewhere (``stages.set_cache_dir``
points it at ``<cache dir>/build``); ``ON_BUILD``, when set, hears how
many libraries each ``build_all`` built and how many it found current.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.kernels import registry

KERNELS_DIR = Path(__file__).resolve().parent
DEFAULT_BUILD_DIR = KERNELS_DIR.parents[2] / "build"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LOG: dict = {}        # source -> compiler output of its last build
_LOADED: dict = {}    # source -> ctypes.CDLL
ON_BUILD = None       # callable(built, reused), or None


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (None: ``build/`` at the root of
    the checkout).  Libraries already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path) if path else DEFAULT_BUILD_DIR


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _stale(source: str) -> bool:
    lib = library_path(source)
    return not lib.exists() or \
        lib.stat().st_mtime < (KERNELS_DIR / source).stat().st_mtime


def build_all(sources=registry.AUDITED_FILES) -> float:
    """Compile every stale source in parallel; returns the wall seconds.
    Raises with the compiler's output if any build fails."""
    todo = [s for s in sources if _stale(s)]
    if not todo:
        if ON_BUILD is not None:
            ON_BUILD(0, len(sources))
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / s)]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for s, (tmp, p) in procs.items():
        LOG[s], _ = p.communicate()
        if p.returncode == 0:
            os.replace(tmp, library_path(s))
        else:
            failed.append(f"{s} (exit {p.returncode}):\n{LOG[s]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if ON_BUILD is not None:
        ON_BUILD(len(todo), len(sources) - len(todo))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if stale."""
    if source not in _LOADED:
        build_all((source,))
        _LOADED[source] = ctypes.CDLL(str(library_path(source)))
    return _LOADED[source]
