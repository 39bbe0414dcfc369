"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``<kernel>/csrc/<name>.cu`` under this directory becomes one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), compiled for ``sm_90a`` into ``build/repro_torch_kernels/`` at the
root of the checkout.  A library's file name carries a hash of its sources
and flags, so an edited source is rebuilt and an unchanged one is not.
Kernels build on first use (one thread at a time), or all at once through
``build_all``, which starts one ``nvcc`` per source, all together.  A failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # two threads' first use builds once


class BuildError(RuntimeError):
    pass


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise BuildError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                     "the CUDA kernels build only where the CUDA toolkit is")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.iterdir()):  # the .cu and any header beside it
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _build(name: str, src: Path, out: Path) -> str:
    """Run nvcc on ``src`` into ``out``; returns nvcc's output."""
    nvcc = _nvcc()  # raises before any file is made
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed on {name} (exit {proc.returncode}):\n"
                         f"{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return proc.stdout


def _saved_log(out: Path) -> str:
    log = out.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> Dict[str, str]:
    """Build every kernel not yet built, one ``nvcc`` per source, all at once.

    Returns kernel name -> nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel), kept beside the library from the build
    that made it."""
    jobs = {name: (src, _library_path(src)) for name, src in sources().items()}
    todo = {name: job for name, job in jobs.items() if not job[1].exists()}
    logs = {name: _saved_log(out) for name, (_, out) in jobs.items()}
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        futures = {name: pool.submit(_build, name, *job)
                   for name, job in todo.items()}
        logs.update({name: f.result() for name, f in futures.items()})
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LIBS:
            src = sources()[name]
            out = _library_path(src)
            if not out.exists():
                _build(name, src, out)
            _LIBS[name] = ctypes.CDLL(str(out))
        return _LIBS[name]
