"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``evi_rag_tpu_torch/csrc/`` compiles on first use into
``evi_rag_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source rebuilds.
The library has a plain C interface; pointers and the stream pass as
integers.  Nothing here runs at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> pathlib.Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its library is missing, then load it."""
    with _LOCK:
        if source in _LOADED:
            return _LOADED[source]
        out = library_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOG[source] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{BUILD_LOG[source]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LOADED[source] = lib
        return lib
