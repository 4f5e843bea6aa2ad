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

Host code (``csrc/<name>.cpp``: the shared-memory ring of the
multiprocess loader) is not CUDA and never goes to ``nvcc``:
:func:`build_host` compiles it with ``g++`` into the same directory, under
the same hash rule, on the CPU machine as on the GPU machine::

    g++ -O3 -std=c++17 -shared -fPIC -pthread csrc/<name>.cpp \
        -o _build/lib<name>-<hash>.so -lrt
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

GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
GXX_LIBS = ["-lrt"]

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


def _host_target(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()
                            + " ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> pathlib.Path:
    """The library of the host source ``csrc/<name>.cpp``, compiled with
    ``g++`` first if it has no current build. Several processes may ask
    at once (a loader's producers, a test run's workers): one compiles
    under an ``fcntl`` lock, into a temporary file renamed into place, so
    no process ever loads a half-written library. A failed compile raises
    ``RuntimeError`` with the compiler's output."""
    target = _host_target(name)
    if target.exists():
        return target
    import fcntl
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.so.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            return target
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                f"g++ not found on PATH: csrc/{name}.cpp is compiled at "
                "first use (TL_DISABLE_NATIVE=1 opts out of the native "
                "library)")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [gxx, *GXX_FLAGS, str(CSRC / f"{name}.cpp"), "-o", tmp,
               *GXX_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for csrc/{name}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)
    return target


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
