"""Build and load the port's CUDA kernels.

Each source in ``registry.AUDITED_FILES`` compiles on first use into a
shared library with a plain C interface under ``build/`` at the root of the
checkout (listed in ``.gitignore``), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/lib<name>.so <source>

and loads with ``ctypes``.  A library newer than its source (and than the
shared ``analysis.cuh``) is reused.  ``build_all`` starts one ``nvcc`` per
stale source, all at once, and waits for them; the compiler's output
(``-Xptxas=-v``: registers, shared memory and spills per kernel) is kept
in ``LOG`` and beside the library as ``lib<name>.so.log`` (palkit reads
it).  ``build_all(checked=True)`` builds the checked libraries
``lib<name>_checked.so`` (``-DREPRO_KERNEL_CHECKS -lineinfo``: the
device-side checks of ``analysis.cuh``); ``load`` hands them out instead
of the production libraries only in a process that called
``use_checked_libraries()`` before its first load (palkit's ``--run-jobs
--checked`` child).  Each build writes to a
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
CHECKED_FLAGS = ("-DREPRO_KERNEL_CHECKS", "-lineinfo")
HEADER = "analysis.cuh"

LOG: dict = {}        # source -> compiler output of its last build
_LOADED: dict = {}    # source -> ctypes.CDLL
_CHECKED = False      # load the checked libraries (use_checked_libraries)
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


def library_path(source: str, checked: bool = False) -> Path:
    suffix = "_checked" if checked else ""
    return BUILD_DIR / f"lib{Path(source).stem}{suffix}.so"


def log_path(source: str, checked: bool = False) -> Path:
    """The compiler's output of the library's last build."""
    lib = library_path(source, checked)
    return lib.with_name(lib.name + ".log")


def _stale(source: str, checked: bool = False) -> bool:
    lib = library_path(source, checked)
    newest = max((KERNELS_DIR / source).stat().st_mtime,
                 (KERNELS_DIR / HEADER).stat().st_mtime)
    return not lib.exists() or lib.stat().st_mtime < newest


def use_checked_libraries() -> None:
    """Make this process load the checked libraries.  Only palkit's
    ``--run-jobs --checked`` child calls it, before its first load; a
    process that has loaded a library refuses, so no process mixes the two
    builds."""
    global _CHECKED
    if _LOADED:
        raise RuntimeError("use_checked_libraries: libraries already loaded "
                           f"({', '.join(_LOADED)})")
    _CHECKED = True


def build_all(sources=registry.AUDITED_FILES, checked: bool = False
              ) -> float:
    """Compile every stale source in parallel; returns the wall seconds.
    Raises with the compiler's output if any build fails."""
    todo = [s for s in sources
            if (_stale(s, checked=True) if checked else _stale(s))]
    if not todo:
        if ON_BUILD is not None:
            ON_BUILD(0, len(sources))
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    flags = NVCC_FLAGS + (CHECKED_FLAGS if checked else ())
    for s in todo:
        tmp = library_path(s, checked).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(KERNELS_DIR / s)]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for s, (tmp, p) in procs.items():
        log, _ = p.communicate()
        LOG[s if not checked else f"{s} (checked)"] = log
        if p.returncode == 0:
            log_path(s, checked).write_text(log)
            os.replace(tmp, library_path(s, checked))
        else:
            failed.append(f"{s} (exit {p.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if ON_BUILD is not None:
        ON_BUILD(len(todo), len(sources) - len(todo))
    return time.perf_counter() - t0


def loaded_sources() -> tuple:
    """The sources whose libraries this process has loaded."""
    return tuple(_LOADED)


def kernel_attrs(lib, prefix: str) -> list:
    """Every kernel instantiation of a library (``<prefix>_kernel_attrs``
    of ``analysis.cuh``): its name, mangled name and
    ``cudaFuncGetAttributes`` resources."""
    count = getattr(lib, f"{prefix}_kernel_count")
    count.restype = ctypes.c_int
    attrs = getattr(lib, f"{prefix}_kernel_attrs")
    attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                      ctypes.POINTER(ctypes.c_char_p),
                      ctypes.POINTER(ctypes.c_int)]
    attrs.restype = ctypes.c_int
    out = []
    for i in range(count()):
        name, mangled = ctypes.c_char_p(), ctypes.c_char_p()
        vals = (ctypes.c_int * 5)()
        err = attrs(i, ctypes.byref(name), ctypes.byref(mangled), vals)
        if err:
            raise RuntimeError(f"{prefix}_kernel_attrs({i}) failed with "
                               f"CUDA error {err}")
        out.append(dict(
            name=name.value.decode(),
            mangled=mangled.value.decode() if mangled.value else None,
            regs=vals[0], smem_static=vals[1], local_bytes=vals[2],
            max_threads=vals[3], max_dynamic_smem=vals[4]))
    return out


MAX_LAUNCHES = 512     # rows a launch-config query returns at most


def launch_rows(prefix: str, n: int, rows) -> list:
    """Decode a ``<prefix>_launch_config`` answer: one dict per launch
    (``kernel`` index in ``kernel_attrs``, ``grid``, ``block``,
    ``smem_dynamic``)."""
    if n < 0:
        raise RuntimeError(f"{prefix}_launch_config failed with CUDA "
                           f"error {-n}")
    if n > MAX_LAUNCHES:
        raise RuntimeError(f"{prefix}_launch_config: {n} launches, more "
                           f"than the {MAX_LAUNCHES} asked for")
    return [dict(kernel=rows[4 * i], grid=rows[4 * i + 1],
                 block=rows[4 * i + 2], smem_dynamic=rows[4 * i + 3])
            for i in range(n)]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if stale: the checked
    library after ``use_checked_libraries()``."""
    if source not in _LOADED:
        build_all((source,), checked=_CHECKED)
        _LOADED[source] = ctypes.CDLL(str(library_path(source, _CHECKED)))
    return _LOADED[source]
