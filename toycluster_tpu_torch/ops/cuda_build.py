"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/toycluster_tpu_torch/`` at the root of the checkout, keyed by a
hash of the source, the headers of ``csrc/`` and the flags, and loaded
with ``ctypes``.  ``build`` compiles several kernels at once, one ``nvcc``
process each.  Nothing is compiled at import time; the CPU never reaches
this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "toycluster_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
build_log: dict = {}       # name -> nvcc's register/shared-memory report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    blob = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names) -> None:
    """Compile the kernels ``names`` that are not built yet, all nvcc
    processes started together; raises if any fails."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, lib_path in todo:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, lib_path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib_path, tmp, proc in procs:
        out, err = proc.communicate()
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, building it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    build([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    _LIBS[name] = lib
    return lib
