"""Port vs JAX: reading a materialized split (``dataset.source=normalized``).

The JAX package builds a small normalized dataset; the port's store reader
and ``load_retrieval_split`` must give the same samples, and the port's
``serve`` task on it the same textualized triples and recall as the JAX task
(f32 compute, identical rankings).
"""

import json
import pathlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from bench import make_bundle
from evi_rag_tpu import cli as jcli
from evi_rag_tpu.data import bfs_label as jbfs
from evi_rag_tpu.data.pipeline import PipelineConfig, build_pipeline, load_retrieval_split as j_load
from evi_rag_tpu.data.store import SampleStore as JStore
from evi_rag_tpu.data.text_encoder import HashTextEncoder
from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu.utils.config import load_config as j_load_config
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.data.pipeline import load_retrieval_split as t_load
from evi_rag_tpu_torch.data.store import SampleStore as TStore
from evi_rag_tpu_torch.train import checkpoint as tck

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
DIM = 32


@pytest.fixture(scope="module")
def normalized(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_norm")
    rng = np.random.default_rng(0)
    ents = [f"e{i}" for i in range(40)]
    rels = [f"r{i}" for i in range(6)]

    def rows(prefix, n):
        out = []
        for q in range(n):
            pick = rng.choice(len(ents), size=12, replace=False)
            graph = [[ents[pick[i]], rels[rng.integers(6)], ents[pick[i + 1]]] for i in range(11)]
            graph += [[ents[pick[rng.integers(12)]], rels[rng.integers(6)], ents[pick[rng.integers(12)]]]
                      for _ in range(15)]
            out.append({"id": f"{prefix}{q}", "question": f"question {prefix}{q}",
                        "q_entity": [ents[pick[0]]], "a_entity": [ents[pick[3]]], "graph": graph})
        return out

    raw = tmp / "raw"
    raw.mkdir()
    pq.write_table(pa.Table.from_pylist(rows("v", 6)), raw / "validation-00000.parquet")
    pq.write_table(pa.Table.from_pylist(rows("t", 3)), raw / "train-00000.parquet")
    out = tmp / "normalized"
    # The numpy BFS engine: no port test compiles native/libgraphcore.so,
    # which JAX tests in other workers may be building at the same time.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("evi_rag_tpu.data.pipeline.best_shortest_path_union", jbfs.shortest_path_union_by_pair)
        build_pipeline(PipelineConfig(dataset="toy", raw_root=str(raw), out_dir=str(out)),
                       HashTextEncoder(dim=DIM))
    return tmp, out


def test_store_reader_matches_jax(normalized):
    _, out = normalized
    path = out / "materialized" / "validation"
    js, ts = JStore(path, expected_artifact="g_retrieval"), TStore(path, expected_artifact="g_retrieval")
    assert js.ids == ts.ids and len(ts) == 6
    for sid in js.ids:
        a, b = js.get(sid), ts.get(sid)
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]
    with pytest.raises(ValueError, match="artifact mismatch"):
        TStore(path, expected_artifact="other")


@pytest.mark.parametrize("kw", [{}, {"sample_limit": 4, "seed": 3}])
def test_load_retrieval_split_matches_jax(normalized, kw):
    _, out = normalized
    js, jq = j_load(out, "validation", **kw)
    ts, tq = t_load(out, "validation", **kw)
    np.testing.assert_array_equal(tq, jq)
    assert [s.sample_id for s in ts] == [s.sample_id for s in js]
    for a, b in zip(js, ts):
        for name in ("edge_index", "edge_relations", "node_embedding_ids", "topic_locals",
                     "edge_labels", "node_entity_ids", "pair_shortest_len"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        assert a.num_nodes == b.num_nodes and a.question_id == b.question_id


def test_serve_task_on_normalized_matches_jax(normalized):
    tmp, out = normalized
    params = {"params": make_bundle(DIM, DIM, 20, seed=4)["features"]}
    jck.save_checkpoint(tmp / "jax_ckpt", params)
    tree, meta = jck.load_checkpoint(tmp / "jax_ckpt")
    tck.save_checkpoint(tmp / "port_ckpt", tree["params"], meta=meta)
    common = ["dataset.source=normalized", f"dataset.normalized_dir={out}",
              "serve.splits=[validation]", "serve.k=8", "serve.k_values=[1, 5]",
              "serve.compute_dtype=float32"]
    jcfg = j_load_config(CONFIGS, "serve", common + [f"retriever.ckpt={tmp / 'jax_ckpt'}"])
    jcfg["task_name"] = "serve"
    jrun = tmp / "jax_run"
    jrun.mkdir()
    jm = jcli.task_serve.__wrapped__(jcfg, run_dir=jrun)
    logs = tmp / "port_logs"
    assert tcli.main(["serve", "--configs-dir", CONFIGS, *common, "device=cpu",
                      f"retriever.ckpt={tmp / 'port_ckpt'}", f"paths.log_dir={logs}"]) == 0
    (tmetrics,) = logs.glob("**/metrics.json")
    tm = json.loads(tmetrics.read_text())
    assert set(tm) == set(jm)
    for key in ("validation/serve/recall@1", "validation/serve/recall@5", "validation/num_questions"):
        assert tm[key] == jm[key], key
    rows = lambda p: [json.loads(x) for x in p.read_text().splitlines()]
    rt, rj = rows(tmetrics.parent / "validation_serve.jsonl"), rows(jrun / "validation_serve.jsonl")
    assert [r["triples"] for r in rt] == [r["triples"] for r in rj]
    assert isinstance(rt[0]["triples"][0][0], str)  # textualized through the vocab
