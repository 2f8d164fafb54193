"""ctypes bindings of the native graphcore library, built on first use.

Counterpart of ``evi_rag_tpu/data/native.py``.  ``shortest_path_union_by_pair``
has two engines: the vectorized numpy one (``data/bfs_label.py``) and the C++
one (``csrc/graphcore.cpp``), which ``ops/_build.load_host_library`` compiles
with g++ into ``_build/`` on first use.  Both give the same outputs.
``best_shortest_path_union`` picks the native engine when the library loads
and the numpy one otherwise, as the JAX package does;
``best_shortest_path_union.runs`` counts the calls that each engine served.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from evi_rag_tpu_torch.data import bfs_label

SOURCE = "graphcore.cpp"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def load_library(*, build_if_missing: bool = True) -> ctypes.CDLL | None:
    """The graphcore library, or None when it cannot be built or loaded (a
    failure is remembered for the life of the process)."""
    from evi_rag_tpu_torch.ops import _build

    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not build_if_missing and not _build.host_library_path(SOURCE).exists():
                raise FileNotFoundError(_build.host_library_path(SOURCE))
            lib = _build.load_host_library(SOURCE)
        except (OSError, RuntimeError):
            _load_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.evi_bfs_pair_labels.restype = ctypes.c_int64
        lib.evi_bfs_pair_labels.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, i64p, ctypes.c_int64, i64p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), i64p, i64p, i64p, i64p,
            ctypes.POINTER(i64p), i64p,
        ]
        lib.evi_free_i64.restype = None
        lib.evi_free_i64.argtypes = [i64p]
        lib.evi_bfs_dist.restype = None
        lib.evi_bfs_dist.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, i64p, ctypes.c_int, i64p,
        ]
        _lib = lib
        return _lib


def _as_i64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int64))


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def shortest_path_union_by_pair_native(
    *,
    num_nodes: int,
    edge_src,
    edge_dst,
    sources,
    targets,
    path_mode: str = "undirected",
):
    """Native engine with the exact ``bfs_label`` return contract."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("graphcore native library unavailable")
    if path_mode not in ("undirected", "qa_directed"):
        raise ValueError(f"unknown path_mode {path_mode!r}")
    src = _as_i64(edge_src)
    dst = _as_i64(edge_dst)
    ss = _as_i64(sources)
    aa = _as_i64(targets)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("edge_src and edge_dst must be 1-D arrays of one length")
    e = src.shape[0]
    mask = np.zeros(e, dtype=np.uint8)
    max_pairs = max(int(ss.size) * int(aa.size), 1)
    pair_start = np.zeros(max_pairs, np.int64)
    pair_answer = np.zeros(max_pairs, np.int64)
    pair_len = np.zeros(max_pairs, np.int64)
    pair_counts = np.zeros(max_pairs, np.int64)
    edge_ids_ptr = ctypes.POINTER(ctypes.c_int64)()
    edge_total = ctypes.c_int64(0)

    n_pairs = lib.evi_bfs_pair_labels(
        int(num_nodes), int(e), _ptr(src), _ptr(dst),
        int(ss.size), _ptr(ss), int(aa.size), _ptr(aa),
        1 if path_mode == "qa_directed" else 0,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(pair_start), _ptr(pair_answer), _ptr(pair_len), _ptr(pair_counts),
        ctypes.byref(edge_ids_ptr), ctypes.byref(edge_total),
    )
    if n_pairs < 0:
        raise RuntimeError("evi_bfs_pair_labels failed")
    try:
        total = int(edge_total.value)
        edge_ids = (
            np.ctypeslib.as_array(edge_ids_ptr, shape=(total,)).copy().tolist()
            if total
            else []
        )
    finally:
        if edge_ids_ptr:
            lib.evi_free_i64(edge_ids_ptr)
    return (
        mask.astype(bool),
        pair_start[:n_pairs].tolist(),
        pair_answer[:n_pairs].tolist(),
        edge_ids,
        pair_counts[:n_pairs].tolist(),
        pair_len[:n_pairs].tolist(),
    )


def bfs_dist(num_nodes: int, edge_src, edge_dst, sources, *, undirected: bool = True) -> np.ndarray:
    """Multi-source BFS distances through the native library (-1 where
    unreachable); the numpy counterpart is ``bfs_label.bfs_dist`` over
    ``bfs_label.build_csr``."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("graphcore native library unavailable")
    src, dst, ss = _as_i64(edge_src), _as_i64(edge_dst), _as_i64(sources)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("edge_src and edge_dst must be 1-D arrays of one length")
    out = np.empty(int(num_nodes), np.int64)
    lib.evi_bfs_dist(int(num_nodes), int(src.size), _ptr(src), _ptr(dst), int(ss.size), _ptr(ss),
                     1 if undirected else 0, _ptr(out))
    return out


def best_shortest_path_union(**kwargs):
    """Native when the library loads, numpy otherwise (the same results)."""
    if load_library() is not None:
        try:
            out = shortest_path_union_by_pair_native(**kwargs)
        except RuntimeError:
            pass
        else:
            best_shortest_path_union.runs["native"] += 1
            return out
    best_shortest_path_union.runs["numpy"] += 1
    return bfs_label.shortest_path_union_by_pair(**kwargs)


best_shortest_path_union.runs = {"native": 0, "numpy": 0}
