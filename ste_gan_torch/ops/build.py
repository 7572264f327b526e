"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ste_gan_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``),
into ``build/ste_gan_torch/`` at the root of the checkout. A library's file
name carries a hash of its source and of the flags, so an edited source
builds anew and an unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source, all at once. Nothing is built when this module is
imported: the first call that needs a library builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ste_gan_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature (argument types) of every exported function, by library.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "grouped_conv": {
        "grouped_conv1d_fwd": [_P, _P, _P] + [_I] * 15 + [_P],
        "grouped_conv1d_dw": [_P, _P, _P, _P] + [_I] * 15 + [_P],
    },
    "adamw": {
        "adamw_multi_tensor": [_P] * 7 + [_I, _I, _P, _P, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: What the last build printed (ptxas register and shared-memory counts).
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all() -> float:
    """Build every library not yet built, one nvcc per source in parallel.
    Returns the seconds it took."""
    start = time.perf_counter()
    with _lock:
        jobs = {name: _start(name) for name in SIGNATURES}
        for name, (target, pending) in jobs.items():
            _finish(name, target, pending)
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every
    function's argument and return types declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        target, pending = _start(name)
        _finish(name, target, pending)
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
