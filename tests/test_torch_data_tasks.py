"""Port vs JAX: the ``build``, ``seed_stats`` and ``bfs_chains`` tasks.

Both packages' CLIs run on the same inputs (the port with ``device=cpu``):
a synthetic raw dataset of ``testing.synthetic_rows`` (the WebQSP preset's
generator at a small pool and edge cap), built with the hash encoder and
with the tiny gte checkpoint, then ``seed_stats`` on the built and on the
synthetic source, and ``bfs_chains`` over agent stores made from the built
split.  ``metrics.json``, the built datasets, ``eval_bfs/<split>.jsonl`` and
the manifests must be equal, times aside.  Both builds label with the numpy
BFS engine.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from _torch_build_common import assert_same_build, pin_jax_numpy_engine, write_tiny_gte
from evi_rag_tpu import cli as jcli
from evi_rag_tpu.utils.config import load_config as j_load_config
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch import testing
from evi_rag_tpu_torch.data import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = str(ROOT / "configs")
SMALL = dict(counts={"train": 6, "validation": 4, "test": 0}, pool=400, relations=24, edge_cap=64)


def _script():
    spec = importlib.util.spec_from_file_location("make_synthetic_webqsp", ROOT / "scripts" / "make_synthetic_webqsp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_rows_are_the_scripts_rows():
    """The numpy copy of the generator draws the script's rows for the same
    seed (the script's main loop, at a small pool and edge cap)."""
    mod = _script()
    rng = np.random.default_rng(3)
    ents, _ = mod._entity_pool(400, rng)
    rels = mod._relation_pool(24, rng)
    preset = mod._PRESETS["webqsp"]
    hop_mix = tuple(float(p) for p in preset["hop_mix"].split(","))
    want = [(split, [mod.make_question(f"{preset['prefix'][split]}-{i}", rng, ents, rels, edge_cap=64,
                                       hop_mix=hop_mix, lognorm_mean=preset["lognorm_mean"]) for i in range(n)])
            for split, n in (("train", 5), ("validation", 3))]
    got = list(testing.synthetic_rows(seed=3, counts={"train": 5, "validation": 3, "test": 0}, pool=400,
                                      relations=24, edge_cap=64))
    assert got == want
    assert testing.PRESETS["webqsp"]["hop_mix"] == hop_mix
    assert {k: testing.PRESETS["webqsp"][k] for k in ("train", "validation", "test", "pool", "relations")} == \
        {k: preset[k] for k in ("train", "validation", "test", "pool", "relations")}


def test_hash_tokenizer_contract():
    tok = testing.HashTokenizer(30528)
    out = tok(["Entity 1234 Film", "people.person.place_of_birth", "", "a b c d e f g h"], max_length=6)
    ids, mask = out["input_ids"], out["attention_mask"]
    assert ids.dtype == mask.dtype == np.int64 and ids.shape == mask.shape == (4, 6)
    assert ids[:, 0].tolist() == [2] * 4 and mask.sum(1).tolist() == [5, 6, 2, 6]
    assert ids[2, :2].tolist() == [2, 3] and ids[3, 5] == 3 and ids[2, 2:].tolist() == [0] * 4
    real = ids[mask.astype(bool) & (ids > 3)]
    assert (real >= 5).all() and (real < 30528).all()
    assert tok(["Entity 1234 Film"], max_length=6)["input_ids"].tolist() == ids[:1].tolist()
    with pytest.raises(ValueError):
        tok(["x"], padding=True)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    import test_raw_ingestion as raw_fx

    root = tmp_path_factory.mktemp("synth") / "raw"
    root.mkdir()
    for split, rows in testing.synthetic_rows(seed=0, **SMALL):
        pq.write_table(pa.Table.from_pylist(rows, schema=raw_fx.ROG_SCHEMA), root / f"{split}-00000-of-00001.parquet")
    return root


def _jax_task(task, overrides, run_dir):
    cfg = j_load_config(CONFIGS, task, overrides)
    cfg["task_name"] = task
    run_dir.mkdir(parents=True)
    return jcli.TASKS[task].__wrapped__(cfg, run_dir=run_dir)


def _port_task(task, overrides, log_dir):
    assert tcli.main([task, "--configs-dir", CONFIGS, *overrides, f"paths.log_dir={log_dir}"]) == 0
    (metrics,) = log_dir.glob("**/metrics.json")
    return json.loads(metrics.read_text())


@pytest.fixture(scope="module")
def built(raw, tmp_path_factory):
    """Both build CLIs (hash encoder, dim 32) on the synthetic raw data."""
    tmp = tmp_path_factory.mktemp("built")
    common = ["build=webqsp", f"build.raw_root={raw}", "build.encoder.dim=32"]
    with pytest.MonkeyPatch.context() as mp:
        pin_jax_numpy_engine(mp)
        mp.setattr(native, "load_library", lambda **kw: None)  # the port's selector then picks numpy
        jm = _jax_task("build", [*common, f"build.out_dir={tmp / 'jax'}"], tmp / "jax_run")
        tm = _port_task("build", [*common, f"build.out_dir={tmp / 'port'}", "device=cpu"], tmp / "port_logs")
    return tmp, jm, tm


def test_build_clis_match(built):
    tmp, jm, tm = built
    assert tm == jm and jm["count/kept/train"] == 6 and jm["num_text_entities"] < jm["num_entities"]
    assert_same_build(tmp / "jax", tmp / "port")


def test_build_clis_match_with_gte(raw, tmp_path, monkeypatch):
    """``encoder.kind=gte_jax``: the JAX package's gte and the port's, the
    parity gate skipped loudly by both (the tiny checkpoint has no HF
    reference), the embeddings within f32 rounding."""
    pin_jax_numpy_engine(monkeypatch)
    monkeypatch.setattr(native, "load_library", lambda **kw: None)
    gte = write_tiny_gte(tmp_path / "gte")
    common = ["build=webqsp", f"build.raw_root={raw}", "build.encoder.kind=gte_jax",
              f"build.encoder.model_path={gte}", "build.encoder.max_length=32"]
    jm = _jax_task("build", [*common, f"build.out_dir={tmp_path / 'jax'}"], tmp_path / "jax_run")
    tm = _port_task("build", [*common, f"build.out_dir={tmp_path / 'port'}", "device=cpu"], tmp_path / "logs")
    assert tm == jm
    assert_same_build(tmp_path / "jax", tmp_path / "port", emb_tol=(1e-4, 1e-5))


@pytest.mark.parametrize("source", ["normalized", "synthetic"])
def test_seed_stats_clis_match(built, source, tmp_path):
    tmp = built[0]
    data = ([f"dataset.source=normalized", f"dataset.normalized_dir={tmp / 'port'}"] if source == "normalized"
            else ["dataset.num_samples=24", "dataset.emb_dim=16"])
    common = [*data, "eval.splits=[train, validation]"]
    jm = _jax_task("seed_stats", common, tmp_path / "jax_run")
    tm = _port_task("seed_stats", common, tmp_path / "logs")
    assert set(tm) == set(jm) and any(k.startswith("validation/") for k in jm)
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], rel=1e-12), key


def _agent_stores(normalized: pathlib.Path, out: pathlib.Path) -> None:
    """Agent stores of the built train and validation splits: seeded random
    retriever scores, the positives lifted by 2, the top 24 edges."""
    from evi_rag_tpu_torch.data.g_agent import AgentSettings, build_agent_sample
    from evi_rag_tpu_torch.data.pipeline import load_retrieval_split
    from evi_rag_tpu_torch.eval.artifacts import save_agent_store

    rng = np.random.default_rng(0)
    for split in ("train", "validation"):
        samples, _ = load_retrieval_split(normalized, split)
        agents = []
        for s in samples:
            scores = (rng.normal(size=s.edge_index.shape[1]) + 2.0 * s.edge_labels).astype(np.float32)
            a = build_agent_sample(
                sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
                relations=s.edge_relations, labels=s.edge_labels.astype(np.float32), scores=scores,
                node_entity_ids=s.node_entity_ids, node_embedding_ids=s.node_embedding_ids,
                start_entity_ids=s.node_entity_ids[s.topic_locals], answer_entity_ids=s.answer_entity_ids,
                settings=AgentSettings(edge_top_k=24))
            if a is not None:
                agents.append(a)
        assert agents
        save_agent_store(agents, out / split, split=split)


@pytest.mark.parametrize("source", ["normalized", "synthetic"])
def test_bfs_chains_clis_match(built, source, tmp_path):
    """Over the same agent stores: the same chains (textualized through the
    vocab on the normalized source), manifests and metrics."""
    tmp = built[0]
    _agent_stores(tmp / "port", tmp_path / "g_agent")
    data = ([f"dataset.source=normalized", f"dataset.normalized_dir={tmp / 'port'}"] if source == "normalized"
            else [])
    common = [*data, f"gflownet.g_agent_dir={tmp_path / 'g_agent'}", "eval.splits=[train, validation]",
              "bfs_chains.max_chains_per_sample=20"]
    jm = _jax_task("bfs_chains", [*common, f"eval.artifacts_dir={tmp_path / 'jax_art'}"], tmp_path / "jax_run")
    tm = _port_task("bfs_chains", [*common, f"eval.artifacts_dir={tmp_path / 'port_art'}"], tmp_path / "logs")
    assert tm == jm and jm["train/num_samples"] > 0
    for split in ("train", "validation"):
        a = (tmp_path / "jax_art" / "eval_bfs" / f"{split}.jsonl").read_text()
        b = (tmp_path / "port_art" / "eval_bfs" / f"{split}.jsonl").read_text()
        assert a == b and a.count("\n") == jm[f"{split}/num_samples"]
        assert ("chain_text" in a) == (source == "normalized")
        ma, mb = (json.loads((tmp_path / d / "eval_bfs" / f"{split}.manifest.json").read_text())
                  for d in ("jax_art", "port_art"))
        drop = ("created_at", "producer")
        assert {k: v for k, v in ma.items() if k not in drop} == {k: v for k, v in mb.items() if k not in drop}
