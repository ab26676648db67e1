"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source under ``kernels/<name>/csrc/`` has a plain C entry
point; it is compiled on first use into ``build/kernels/`` at the repo
root (listed in ``.gitignore``), keyed by a hash of its sources and
flags, and loaded with ``ctypes``.  Nothing is compiled or loaded when a
module is imported: the CPU tests import every module on a machine with
no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
# -Xptxas=-v prints registers / shared memory / spills per kernel into the
# build log; it does not change the binary.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict = {}        # library path -> loaded ctypes.CDLL
BUILD_LOGS: dict = {}   # library path -> nvcc output of the build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "port's kernels)")


def library_path(name: str, sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_library(name: str, sources) -> Path:
    """nvcc ``sources`` into a shared library unless an up-to-date one is
    already built; returns its path.  Raises with nvcc's output on a
    failed build."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[str(out)] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources) -> ctypes.CDLL:
    path = str(compile_library(name, sources))
    with _LOCK:
        if path not in _LIBS:
            _LIBS[path] = ctypes.CDLL(path)
        return _LIBS[path]


def build_all(kernels: dict) -> dict:
    """Compile every ``{name: sources}`` entry at once, one nvcc each,
    all started together.  Returns ``{name: library path}``."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(kernels))) as ex:
        futs = {name: ex.submit(compile_library, name, srcs)
                for name, srcs in kernels.items()}
        return {name: f.result() for name, f in futs.items()}
