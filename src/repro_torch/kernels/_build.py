"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the root of the checkout, at first use, and
loaded with ``ctypes``.  The library's file name carries a hash of the
source and of every ``#include "..."`` header it reaches under ``csrc/``
(``source_digest``), so an edited source or header is rebuilt and a stale
library is never loaded.  ``build(name, edit)`` builds a copy of the
source's text changed by ``edit`` (a diagnostic build, such as clock
stamps) beside the real one.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "sources", "source_digest",
           "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[Tuple[str, Optional[Callable[[str], str]]], ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> Path:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        p = Path(root) / "bin" / "nvcc"
        if p.is_file():
            return p
    raise FileNotFoundError(
        "nvcc not found under $CUDA_HOME/bin or /usr/local/cuda/bin")


def sources(name: str, csrc: Optional[Path] = None) -> List[Path]:
    """``<name>.cu`` under ``csrc`` (default ``CSRC``) and every file it
    reaches through ``#include "..."``, resolved next to the including
    file: each once, in the order first reached."""
    root = Path(csrc) if csrc is not None else CSRC
    seen: List[Path] = []
    todo = [root / f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for inc in _INCLUDE.findall(f.read_text()):
            dep = f.parent / inc
            if dep.is_file():
                todo.append(dep)
    return seen


def source_digest(name: str, csrc: Optional[Path] = None) -> str:
    """Hash of ``<name>.cu`` and of every header it includes under
    ``csrc``: it names the built library, so editing either rebuilds."""
    h = hashlib.sha1()
    for f in sources(name, csrc):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def build(name: str, edit: Optional[Callable[[str], str]] = None
          ) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    with ``edit``, a copy of its text changed by ``edit``, written under
    ``BUILD_DIR`` and named by a hash of that text too.  Returns (library
    path, seconds spent compiling, compiler log)."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(name)
    if edit is not None:
        text = edit(src.read_text())
        digest = hashlib.sha1((digest + text).encode()).hexdigest()[:12]
        name, src = f"{name}-edited", BUILD_DIR / f"{name}-edited-{digest}.cu"
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if edit is not None:
        src.write_text(text)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [str(nvcc_path()), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
           str(src)]
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


def load(name: str, edit: Optional[Callable[[str], str]] = None
         ) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (``edit``: of its edited
    copy, as ``build``), built on first use."""
    if (name, edit) not in _loaded:
        _loaded[name, edit] = ctypes.CDLL(str(build(name, edit)[0]))
    return _loaded[name, edit]
