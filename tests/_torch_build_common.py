"""Shared inputs of the port's build tests: the raw fixtures of
``tests/test_raw_ingestion.py`` and ``tests/test_data_pipeline.py`` as
(writer, PipelineConfig keywords, column map), a tiny gte checkpoint
directory, the JAX engine pin, and the comparison of two built datasets."""

import json
import pathlib

import numpy as np
import pyarrow.parquet as pq
import torch

import test_data_pipeline as dp_fx
import test_raw_ingestion as raw_fx
from evi_rag_tpu.data import bfs_label as jbfs
from evi_rag_tpu_torch.data.gte import GTEConfig
from evi_rag_tpu_torch.testing import random_gte_state

KGQAGEN_MAP = {"question_id_field": "id", "question_field": "question", "answer_text_field": "answer",
               "q_entity_field": "seed", "a_entity_field": "answer", "graph_field": "proof"}
GTSQA_MAP = {"question_id_field": "id", "question_field": "question", "answer_text_field": "all_answers_wikidata",
             "q_entity_field": "seed_entities", "a_entity_field": "answer_node", "graph_field": "graph",
             "answer_subgraph_field": "answer_subgraph", "graph_iso_field": "graph_isomorphism",
             "redundant_field": "redundant", "test_type_field": "test_type"}
WIKIDATA = {"mode": "regex", "match_regex": r"^(?!Q\d+|P\d+).+"}


def _rog(raw: pathlib.Path) -> None:
    raw_fx._make_webqsp_raw(raw.parent)  # writes <parent>/raw


def _kgqagen(raw: pathlib.Path) -> None:
    rows = [
        {"id": "kg-0", "question": "capital of country q1", "answer": ["City A (Q2)"], "seed": ["Country B"],
         "proof": [["Country B (Q1)", "capital", "City A (Q2)"], ["City A (Q2)", "population", "5 million"]]},
        {"id": "kg-1", "question": "population of city a", "answer": ["5 million"], "seed": ["City A (Q2)"],
         "proof": [["Country B (Q1)", "capital", "City A (Q2)"], ["City A (Q2)", "population", "5 million"],
                   ["Q7", "P31", "Country B (Q1)"]]},
    ]
    raw_fx._write(raw / "train-00000-of-00001.parquet", rows, raw_fx.KGQAGEN_SCHEMA)


def _gtsqa(raw: pathlib.Path) -> None:
    rows = [
        {"id": "gt-0", "question": "which award", "all_answers_wikidata": ["Award X"],
         "seed_entities": ["Q10"], "answer_node": ["Q20"],
         "graph": [["Q10", "P1", "Q20"], ["Q10", "P2", "Q30"], ["Q30", "P3", "Q20"]],
         "answer_subgraph": [["Q10", "P2", "Q30"], ["Q30", "P3", "Q20"]],
         "graph_isomorphism": "path", "redundant": False, "test_type": ["zero_shot"]},
        {"id": "gt-1", "question": "which place", "all_answers_wikidata": ["Place Y"],
         "seed_entities": ["Q10"], "answer_node": ["Q40"],
         "graph": [["Q10", "P4", "Q40"], ["Q40", "P5", "Q30"]],
         "answer_subgraph": [], "graph_isomorphism": None, "redundant": True, "test_type": []},
    ]
    raw_fx._write(raw / "test-00000-of-00001.parquet", rows, raw_fx.GTSQA_SCHEMA)


def _toy(raw: pathlib.Path) -> None:
    raw.mkdir(parents=True, exist_ok=True)
    dp_fx._write_raw(raw)


# name -> (raw writer, PipelineConfig keywords for both packages, column map)
FIXTURES = {
    "rog": (_rog, dict(dataset="webqsp", text_policy={"mode": "regex", "match_regex": r"^(?!m\.|g\.).*"}), None),
    "kgqagen": (_kgqagen, dict(dataset="kgqagen", text_policy=WIKIDATA, entity_normalization="qid_in_parentheses"),
                KGQAGEN_MAP),
    "gtsqa": (_gtsqa, dict(dataset="gtsqa", text_policy=WIKIDATA), GTSQA_MAP),
    "toy": (_toy, dict(dataset="toy", text_policy={"mode": "exclude_regex", "exclude_regex": r"^m\."},
                       train_filter={"skip_no_ans": True, "skip_no_path": True}), None),
}


def write_fixture(name: str, tmp: pathlib.Path) -> pathlib.Path:
    raw = tmp / "raw"
    FIXTURES[name][0](raw)
    return raw


def pipeline_kwargs(name: str, policy_cls, filter_cls) -> dict:
    """The fixture's PipelineConfig keywords with ``policy_cls`` /
    ``filter_cls`` (the JAX package's or the port's dataclasses)."""
    kw = dict(FIXTURES[name][1])
    kw["text_policy"] = policy_cls(**kw["text_policy"])
    if "train_filter" in kw:
        kw["train_filter"] = filter_cls(**kw["train_filter"])
    return kw


GTE_TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48)


def write_tiny_gte(d: pathlib.Path, seed: int = 0) -> pathlib.Path:
    """A gte checkpoint directory at the tiny geometry: config.json, a BERT
    word-piece tokenizer (the words of ``tests/test_gte_jax.py`` and of the
    fixtures) and ``pytorch_model.bin`` of ``random_gte_state``."""
    from transformers import BertTokenizerFast

    d.mkdir(parents=True, exist_ok=True)
    cfg = {**GTE_TINY, "type_vocab_size": 2, "rope_theta": 160000.0, "layer_norm_eps": 1e-12,
           "hidden_act": "gelu", "model_type": "new"}
    (d / "config.json").write_text(json.dumps(cfg))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "directed", "the", "film", "inception",
             "capital", "of", "france", "a", "question", "city", "berlin", "award", "which", "x", "q"]
    words += [f"tok{i}" for i in range(cfg["vocab_size"] - len(words))]
    (d / "vocab.txt").write_text("\n".join(words))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(str(d))
    torch.save(random_gte_state(GTEConfig(**GTE_TINY), seed), d / "pytorch_model.bin")
    return d


def pin_jax_numpy_engine(monkeypatch) -> None:
    """The JAX build labels with its numpy engine (and so never compiles
    ``native/libgraphcore.so``)."""
    monkeypatch.setattr("evi_rag_tpu.data.pipeline.best_shortest_path_union", jbfs.shortest_path_union_by_pair)


def _manifest(path: pathlib.Path) -> dict:
    m = json.loads(path.read_text())
    return {k: v for k, v in m.items() if k not in ("created_at", "producer")}


def assert_same_build(a: pathlib.Path, b: pathlib.Path, *, emb_tol: tuple[float, float] | None = None) -> None:
    """Two normalized datasets are the same: every store byte for byte
    (``emb_tol``: the question embeddings within (rtol, atol) and every other
    field equal), the embedding tables equal (or within ``emb_tol``), the
    four parquet tables and both filter files equal; manifests equal but
    for their time and producer."""
    from evi_rag_tpu_torch.data.store import SampleStore

    splits = sorted(p.name for p in (a / "materialized").iterdir())
    assert splits == sorted(p.name for p in (b / "materialized").iterdir())
    for split in splits:
        sa, sb = a / "materialized" / split, b / "materialized" / split
        assert _manifest(sa / "manifest.json") == _manifest(sb / "manifest.json")
        assert (sa / "ids.json").read_text() == (sb / "ids.json").read_text()
        if emb_tol is None:
            assert (sa / "data.bin").read_bytes() == (sb / "data.bin").read_bytes(), split
            np.testing.assert_array_equal(np.load(sa / "offsets.npy"), np.load(sb / "offsets.npy"))
            continue
        ra, rb = SampleStore(sa), SampleStore(sb)
        for sid in ra.ids:
            x, y = ra.get(sid), rb.get(sid)
            assert x.keys() == y.keys()
            for key in x:
                if key == "question_emb":
                    np.testing.assert_allclose(y[key], x[key], rtol=emb_tol[0], atol=emb_tol[1])
                elif isinstance(x[key], np.ndarray):
                    assert x[key].dtype == y[key].dtype, key
                    np.testing.assert_array_equal(y[key], x[key], err_msg=key)
                else:
                    assert x[key] == y[key], key
    for name in ("entity_embeddings.npy", "relation_embeddings.npy"):
        ea, eb = np.load(a / "embeddings" / name), np.load(b / "embeddings" / name)
        assert ea.shape == eb.shape and ea.dtype == eb.dtype == np.float32
        if emb_tol is None:
            np.testing.assert_array_equal(eb, ea)
        else:
            np.testing.assert_allclose(eb, ea, rtol=emb_tol[0], atol=emb_tol[1])
    for name in ("graphs.parquet", "questions.parquet", "entity_vocab.parquet", "relation_vocab.parquet"):
        assert pq.read_table(a / name).to_pylist() == pq.read_table(b / name).to_pylist(), name
    for name in ("sub_filter.json", "nonzero_positive_filter.json"):
        assert json.loads((a / name).read_text()) == json.loads((b / name).read_text()), name
