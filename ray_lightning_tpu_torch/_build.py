"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``_build/lib<name>-<hash>.so`` (the directory is listed in
``.gitignore``), for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all together, and waits for every one of them.
Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

PKG = pathlib.Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: every kernel source of the port, by name (``csrc/<name>.cu``)
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (PATH, then torch's CUDA_HOME): the port's CUDA "
        "kernels are compiled from csrc/ at first use")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel source that has no current library,
    one ``nvcc`` process per source, all started together. Returns
    ``{name: compiler output}`` for the sources built now (``-Xptxas -v``
    reports registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def check_routes(lib, symbol: str, routes: Sequence[str]) -> None:
    """Raise unless the library numbers its routes as ``routes`` does.
    ``symbol`` is a C function returning the route names, comma-separated,
    in the numbering its launch takes; a wrapper passes a route as its
    index in ``routes``."""
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_char_p
    names = tuple(fn().decode().split(","))
    if names != tuple(routes):
        raise RuntimeError(f"{symbol}: the library numbers its routes "
                           f"{names}, the wrapper {tuple(routes)}")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed (cached per
    process)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def load_built() -> Sequence[str]:
    """Load every kernel library that is already built, building
    nothing (a warm standby's warm-up: the promoted worker's first step
    then finds each library in this process's cache). Returns the names
    loaded."""
    names = [name for name in SOURCES if _target(name).exists()]
    for name in names:
        load(name)
    return names
