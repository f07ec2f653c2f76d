"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, at first use, and
loaded with ``ctypes``.  The library's file name carries a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Path:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        p = Path(root) / "bin" / "nvcc"
        if p.is_file():
            return p
    raise FileNotFoundError(
        "nvcc not found under $CUDA_HOME/bin or /usr/local/cuda/bin")


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, seconds spent compiling, compiler log)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [str(nvcc_path()), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return lib, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)[0]))
    return _loaded[name]
