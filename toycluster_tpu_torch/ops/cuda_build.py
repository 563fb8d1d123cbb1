"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/toycluster_tpu_torch/`` at the root of the checkout, keyed by a
hash of the source, the headers of ``csrc/`` and the flags, and loaded
with ``ctypes``.  ``build`` compiles several kernels at once, one ``nvcc``
process each.  Nothing is compiled at import time; on the CPU only the
wrappers' argument check ``_check`` runs.  ``csrc=`` builds the sources of
another directory (another tree's kernels, to time them beside this
tree's in one process).  ``_launch`` calls a kernel's C entry point on
the current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    src = csrc / f"{name}.cu"
    blob = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names, csrc: Path = CSRC) -> None:
    """Compile the kernels ``names`` of ``csrc`` that are not built yet,
    all nvcc processes started together; raises if any fails."""
    todo = [(n, _lib_path(n, csrc)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, lib_path in todo:
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, lib_path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
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


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The compiled library of ``<csrc>/<name>.cu``, building it if
    needed."""
    if (name, csrc) not in _LIBS:
        build([name], csrc)
        _LIBS[name, csrc] = ctypes.CDLL(str(_lib_path(name, csrc)))
    return _LIBS[name, csrc]


def _check(name, t, dtype, shape, device):
    """Raise unless tensor ``t`` (argument ``name`` of a kernel wrapper)
    is on ``device`` with ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(lib, args):
    """Launch the C entry point ``<lib>_launch`` of csrc/<lib>.cu on the
    current stream (``_call``)."""
    _call(getattr(load(lib), f"{lib}_launch"), lib, args)


def _call(fn, lib, args):
    """Call the C launcher ``fn`` of kernel ``lib`` on the current stream:
    a tensor (or None) is passed as a pointer, a Python float as a C
    float, anything else as a C int; raises on a CUDA error."""
    fn.argtypes = [ctypes.c_void_p if a is None or torch.is_tensor(a) else
                   ctypes.c_float if isinstance(a, float) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*[a.data_ptr() if torch.is_tensor(a) else
              a if a is None or isinstance(a, float) else int(a)
              for a in args], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {rc}")
