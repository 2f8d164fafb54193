"""Port vs JAX: the data build (``data/pipeline.py``) and the native BFS.

The same raw parquet goes through both packages' ``build_pipeline``, with
the hash encoder and with the tiny gte checkpoint, both labeling with the
numpy BFS engine.  Every store record, the embedding tables, the four
parquet tables, both filter files and the counts must be equal (the gte
embeddings within f32 rounding: rtol 1e-4, atol 1e-5).  The port's row path
over rows held in memory must give what its parquet path gives, its worker
pool what its serial loop gives, and its native engine what its numpy engine
gives.
"""

import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_build_common import (FIXTURES, assert_same_build, pin_jax_numpy_engine, pipeline_kwargs,
                                 write_fixture, write_tiny_gte)
from evi_rag_tpu.data import pipeline as jp
from evi_rag_tpu.data.gte_jax import GTEJaxTextEncoder
from evi_rag_tpu.data.text_encoder import HashTextEncoder as JHash
from evi_rag_tpu_torch.data import bfs_label, native
from evi_rag_tpu_torch.data import pipeline as tp
from evi_rag_tpu_torch.data.gte import GTETextEncoder
from evi_rag_tpu_torch.data.text_encoder import HashTextEncoder as THash
from evi_rag_tpu_torch.ops import _build

GTE_TOL = (1e-4, 1e-5)


@pytest.fixture(scope="module")
def gte_dir(tmp_path_factory):
    return write_tiny_gte(tmp_path_factory.mktemp("gte") / "tiny")


def _build_both(name, tmp, encoders):
    raw = write_fixture(name, tmp)
    cmap = FIXTURES[name][2]
    jkw = pipeline_kwargs(name, jp.TextEntityPolicy, jp.SplitFilter)
    tkw = pipeline_kwargs(name, tp.TextEntityPolicy, tp.SplitFilter)
    jres = jp.build_pipeline(jp.PipelineConfig(raw_root=str(raw), out_dir=str(tmp / "jax"), **jkw), encoders[0],
                             column_map=cmap)
    tres = tp.build_pipeline(tp.PipelineConfig(raw_root=str(raw), out_dir=str(tmp / "port"), **tkw), encoders[1],
                             column_map=cmap)
    return jres, tres


@pytest.mark.parametrize("encoder", ["hash", "gte"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_build_pipeline_matches_jax(name, encoder, tmp_path, monkeypatch, gte_dir):
    pin_jax_numpy_engine(monkeypatch)
    monkeypatch.setattr(native, "load_library", lambda **kw: None)  # the port's selector then picks numpy
    if encoder == "hash":
        encoders = (JHash(dim=16), THash(dim=16))
    else:
        encoders = (GTEJaxTextEncoder(gte_dir), GTETextEncoder(gte_dir, device="cpu"))
    before = dict(native.best_shortest_path_union.runs)
    jres, tres = _build_both(name, tmp_path, encoders)
    assert native.best_shortest_path_union.runs["native"] == before["native"]
    assert native.best_shortest_path_union.runs["numpy"] > before["numpy"]
    for field in ("counts", "num_entities", "num_relations", "num_text_entities"):
        assert getattr(tres, field) == getattr(jres, field), field
    assert_same_build(tmp_path / "jax", tmp_path / "port", emb_tol=None if encoder == "hash" else GTE_TOL)
    if encoder == "gte":
        stats = encoders[1].stats
        assert stats["texts"] == sum(tres.num_texts.values()) and stats["padded_tokens"] == 256 * 64 * stats["batches"]
        assert 0 < stats["real_tokens"] < stats["padded_tokens"]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rows_in_memory_match_the_parquet_path(name, tmp_path):
    """``read_raw_rows`` over the parquet tables' rows (in the parquet
    reader's split order) gives the same samples, and ``build_from_samples``
    over them the same dataset, with ``pyarrow`` only for the final tables."""
    import pyarrow.parquet as pq

    raw = write_fixture(name, tmp_path)
    cmap = FIXTURES[name][2]
    kw = pipeline_kwargs(name, tp.TextEntityPolicy, tp.SplitFilter)
    norm = kw.get("entity_normalization", "none")
    tables = [(split, [r for f in files for r in pq.read_table(f).to_pylist()])
              for split, files in tp._split_files(raw).items()]
    from_rows = list(tp.read_raw_rows(tables, kw["dataset"], column_map=cmap, entity_normalization=norm))
    assert from_rows == list(tp.read_raw_parquet(raw, kw["dataset"], column_map=cmap, entity_normalization=norm))

    cfg = tp.PipelineConfig(raw_root=str(raw), out_dir=str(tmp_path / "parquet"), **kw)
    tp.build_pipeline(cfg, THash(dim=16), column_map=cmap)
    res, out_tables = tp.build_from_samples(dataclasses.replace(cfg, out_dir=str(tmp_path / "rows")), THash(dim=16),
                                            iter(from_rows))
    tp.write_tables(res.out_dir, out_tables)
    assert_same_build(tmp_path / "parquet", tmp_path / "rows")


def test_build_from_rows_needs_no_pyarrow(tmp_path, monkeypatch):
    """Passes 1-4 import no pyarrow: the card's machine has none."""
    rows = [{"id": "q0", "question": "who directed inception", "q_entity": ["Inception"],
             "a_entity": ["Christopher Nolan"], "graph": [["Inception", "directed_by", "Christopher Nolan"],
                                                          ["Inception", "starring", "Leonardo DiCaprio"]]}]
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    cfg = tp.PipelineConfig(dataset="toy", raw_root="", out_dir=str(tmp_path / "out"))
    res, tables = tp.build_from_samples(cfg, THash(dim=8), tp.read_raw_rows([("train", rows)], "toy"))
    assert res.counts["kept"] == {"train": 1} and res.num_texts == {"entities": 3, "relations": 2, "questions": 1}
    assert [r["num_positive"] for r in tables["graphs.parquet"]] == [1]
    samples, q = tp.load_retrieval_split(tmp_path / "out", "train")
    assert len(samples) == 1 and q.shape == (1, 8)
    with pytest.raises(ImportError):
        tp.write_tables(res.out_dir, tables)


def test_workers_match_the_serial_build(tmp_path):
    """``num_workers=2`` (spawned processes) gives the records of
    ``num_workers=0`` in the same order."""
    raw = write_fixture("rog", tmp_path)
    kw = pipeline_kwargs("rog", tp.TextEntityPolicy, tp.SplitFilter)
    for out, workers in (("serial", 0), ("pool", 2)):
        tp.build_pipeline(tp.PipelineConfig(raw_root=str(raw), out_dir=str(tmp_path / out), num_workers=workers,
                                            **kw), THash(dim=16))
    assert_same_build(tmp_path / "serial", tmp_path / "pool")


# --------------------------------------------------------------------------- #
# native engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    assert lib is not None, "g++ could not build csrc/graphcore.cpp"
    return lib


def _random_case(rng, n=40, e=120, n_starts=2, n_answers=3):
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    src[rng.random(e) < 0.02] = -1
    dst[rng.random(e) < 0.02] = n + 5
    return dict(num_nodes=n, edge_src=src, edge_dst=dst, sources=rng.integers(0, n, size=n_starts),
                targets=rng.integers(0, n, size=n_answers))


@pytest.mark.parametrize("mode", ["undirected", "qa_directed"])
def test_native_engine_matches_numpy(mode, lib):
    """The random graphs of ``tests/test_native_graphcore.py``: the same
    mask, pairs, counts and lengths, and the same on-path edge ids (the
    engines also agree on their order here)."""
    rng = np.random.default_rng(42)
    for trial in range(12):
        case = _random_case(rng)
        want = bfs_label.shortest_path_union_by_pair(path_mode=mode, **case)
        got = native.shortest_path_union_by_pair_native(path_mode=mode, **case)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"mask trial {trial}")
        assert got[1:3] == want[1:3] and got[4:] == want[4:], trial
        assert sorted(got[3]) == sorted(want[3]) and got[3] == want[3], trial


def test_native_engine_disconnected_empty_and_bfs_dist(lib):
    case = dict(num_nodes=4, edge_src=np.array([0, 2]), edge_dst=np.array([1, 3]), sources=np.array([0]),
                targets=np.array([3]))
    got = native.shortest_path_union_by_pair_native(**case)
    assert not got[0].any() and got[1] == bfs_label.shortest_path_union_by_pair(**case)[1] == []
    empty = dict(num_nodes=0, edge_src=np.zeros(0, np.int64), edge_dst=np.zeros(0, np.int64),
                 sources=np.zeros(0, np.int64), targets=np.zeros(0, np.int64))
    got = native.shortest_path_union_by_pair_native(**empty)
    assert got[0].size == 0 and got[1] == []
    src, dst = np.array([0, 1, 2, 4, 7]), np.array([1, 2, 3, 5, 2])
    for undirected in (True, False):
        want = bfs_label.bfs_dist(8, *bfs_label.build_csr(8, src, dst, undirected=undirected), np.array([0, 4]))
        np.testing.assert_array_equal(native.bfs_dist(8, src, dst, [0, 4], undirected=undirected), want)


def test_engine_selector_counts_what_ran(lib, monkeypatch):
    """The native engine when the library loads, numpy when it does not;
    ``runs`` counts each."""
    case = _random_case(np.random.default_rng(1))
    runs = native.best_shortest_path_union.runs
    before = dict(runs)
    with_lib = native.best_shortest_path_union(**case)
    monkeypatch.setattr(native, "load_library", lambda **kw: None)
    without = native.best_shortest_path_union(**case)
    assert runs == {"native": before["native"] + 1, "numpy": before["numpy"] + 1}
    np.testing.assert_array_equal(with_lib[0], without[0])
    assert with_lib[1:] == without[1:]


def test_concurrent_builds_leave_a_loadable_library(tmp_path):
    """Four processes that build ``graphcore.cpp`` into one empty directory
    at once leave one whole library (each g++ writes a file of its own that
    is renamed into place) and no temporary file."""
    code = ("import pathlib, sys; from evi_rag_tpu_torch.ops import _build; "
            "_build.BUILD_DIR = pathlib.Path(sys.argv[1]); print(_build.load_host_library('graphcore.cpp'))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == [_build.host_library_path("graphcore.cpp").name], files
    lib = ctypes.CDLL(str(tmp_path / files[0]))
    out = np.empty(3, np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    src, dst, seeds = np.array([0, 1], np.int64), np.array([1, 2], np.int64), np.array([0], np.int64)
    lib.evi_bfs_dist(ctypes.c_int64(3), ctypes.c_int64(2), ptr(src), ptr(dst), ctypes.c_int64(1), ptr(seeds),
                     ctypes.c_int(1), ptr(out))
    assert out.tolist() == [0, 1, 2]
