"""Build the package's CUDA sources at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>.so`` beside the package (listed in
``.gitignore``), then loaded with ctypes.  A build is redone when the
source is newer than the library.  A failed build raises with the
compiler's output; nothing falls back.  A library's first load in a
process is the span ``lib-load``, and a build within it ``lib-build``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

from distance_tpu_torch.utils.timing import phase_timer

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
# One lock a source, so that different sources build at once.
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each source built
# by this process.
PTXAS: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale;
    returns the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Link to a temp path, then rename: a process that already loaded
    # the old library keeps its mapping.
    tmp = f"{so}.build.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        with phase_timer("lib-build"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run nvcc for {src}: {e}") from None
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, so)
    PTXAS[name] = "\n".join(
        line.strip() for line in proc.stderr.splitlines()
        if line.lstrip().startswith("ptxas info") or "spill" in line)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.
    Different sources may be loaded from several threads at once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            with phase_timer("lib-load"):
                lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
