"""Build and load the port's native libraries (nvcc or g++ -> shared library -> ctypes).

Each CUDA source under ``evi_rag_tpu_torch/csrc/`` compiles on first use into
``evi_rag_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source, of every ``csrc/*.cuh`` header it may include
and of the flags, so an edited source or header rebuilds.  ``build`` starts
one ``nvcc`` per missing library, all at once.  The libraries have a plain C
interface; pointers and the stream pass as integers.  ``load_host_library``
does the same for a C++ source of host code (``csrc/graphcore.cpp``) with
``g++``.  Every compiler writes a temporary file of its own that is then
renamed into place, so processes that build the same library at once each
leave a whole one.  Nothing here runs at import time, and a failed build
raises.
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

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[str]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; raises if any fails."""
    with _LOCK:
        todo = [(s, library_path(s)) for s in sources if not library_path(s).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for source, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs.append((source, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for source, out, tmp, proc in procs:
            BUILD_LOG[source] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(source)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s}:\n{BUILD_LOG[s]}" for s in failed))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its library is missing, then load it."""
    if source in _LOADED:
        return _LOADED[source]
    build([source])
    with _LOCK:
        if source not in _LOADED:
            _LOADED[source] = ctypes.CDLL(str(library_path(source)))
        return _LOADED[source]


def host_library_path(source: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{pathlib.Path(source).stem}-{digest.hexdigest()[:16]}.so"


def load_host_library(source: str) -> ctypes.CDLL:
    """Compile the host C++ source ``csrc/<source>`` with ``g++`` if its
    library is missing, then load it; raises if the build fails."""
    with _LOCK:
        if source in _LOADED:
            return _LOADED[source]
        out = host_library_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(CSRC / source), "-o", str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            BUILD_LOG[source] = proc.stdout
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed:\n{source}:\n{proc.stdout}")
            os.replace(tmp, out)
        _LOADED[source] = ctypes.CDLL(str(out))
        return _LOADED[source]
