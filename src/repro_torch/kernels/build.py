"""Build and load the port's CUDA kernels (plain C ABI, bound with ctypes).

Each `csrc/*.cu` source compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the repository root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <lib> csrc/<name>.cu

The hash covers the source, the shared header and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
`build_all` starts one `nvcc` per source at once and waits for all of
them; a missing `nvcc` or a failed build raises.  Nothing is built when
this module is imported.

Every wrapper shares the binding helpers below: `check_arg` (device,
dtype, shape and contiguity of one operand), `bind` (a C entry point with
its return type) and `raise_on` (a nonzero `cudaGetLastError()` code
becomes a `RuntimeError`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "bind", "build_all", "check_arg",
           "load", "raise_on"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> repository root
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("group_aggregate_gather", "group_aggregate_onehot",
           "group_edge_grad", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this
    call (register and shared-memory use per kernel; empty for sources
    already built).  Raises RuntimeError naming the failed source."""
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)        # atomic: a concurrent loader never sees half a file
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def check_arg(name: str, x, dtype, shape, device) -> None:
    """Raise unless tensor ``x`` is on ``device``, of ``dtype`` and
    ``shape``, and contiguous: the kernels take raw pointers."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bind(lib: ctypes.CDLL, fn_name: str):
    """The C entry point with its return type declared; every argument is
    passed as an explicit ctypes value (c_void_p pointers, c_int ints)."""
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return fn


def raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
