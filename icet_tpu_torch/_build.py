"""Builds the port's native sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc``, and each host source
``csrc/<name>.c`` (the scan prefetch queue) by the host C compiler, into a
shared library with a plain C interface, ``_build/<name>-<hash>.so``, where
the hash covers the source, its flags and, for CUDA sources, the shared
headers ``csrc/*.cuh``: an edited source or header builds anew, an
unchanged one is loaded as it is.  Several sources build in parallel, one
compiler each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: ``-fmad=false`` keeps every a*b+c rounded twice, as the plain PyTorch
#: versions compute it with separate operations, so kernel and plain
#: version bin and gate the same points.  No ``--use_fast_math``: bin edges
#: must come from the exact ``atan2f``/``acosf``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

#: the host sources: no Python.h and no setuptools, so a bare toolchain
#: with a C compiler and pthreads builds them
CC_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cc() -> str:
    for cand in ("cc", "gcc", "clang"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C compiler found: the native sources cannot be built")


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.c``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.c"


def library_path(name: str) -> Path:
    """``_build/<name>-<hash>.so``, the hash over the source, its flags and,
    for a CUDA source, every shared header of ``csrc/`` (``*.cuh``, which
    it may include)."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu`` and
    ``csrc/*.c``) that is not built yet, all compilers started together.
    Returns each compiled source's compiler log (for CUDA sources
    ``-Xptxas -v``: registers, shared memory, spills); sources already
    built are absent from it."""
    if names is None:
        names = sorted(p.stem for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.c")])
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = _source(name)
        if src.suffix == ".cu":
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        else:
            cmd = [_cc(), *CC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    logs = {}
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed on {proc.args[-1]}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.c``), built first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
