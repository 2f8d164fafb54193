"""Port vs JAX: the numpy halves of ``eval_retriever``'s artifacts.

``data/g_agent.py``, the store writer, ``eval/ranking.py``, ``data/chains.py``
and ``eval/artifacts.py`` are copies; fed the same arrays, both packages give
equal results (same dtypes, same tie order), and a store record the port
writes is byte for byte the record JAX writes.
"""

import dataclasses
import json

import numpy as np
import pytest

from evi_rag_tpu.data import chains as jchains
from evi_rag_tpu.data import g_agent as jga
from evi_rag_tpu.data import store as jstore
from evi_rag_tpu.eval import artifacts as jart
from evi_rag_tpu.eval import ranking as jrank
from evi_rag_tpu_torch.data import chains as tchains
from evi_rag_tpu_torch.data import g_agent as tga
from evi_rag_tpu_torch.data import store as tstore
from evi_rag_tpu_torch.eval import artifacts as tart
from evi_rag_tpu_torch.eval import ranking as trank


def _random_graph(seed, *, ties=False):
    """A random scored subgraph with a duplicate triple, a duplicate answer
    and (half the time) an answer outside the graph."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 24))
    e = int(rng.integers(6, 60))
    heads, tails = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
    relations = rng.integers(0, 4, size=e)
    heads[1], tails[1], relations[1] = heads[0], tails[0], relations[0]
    scores = rng.normal(size=e).astype(np.float32)
    if ties:
        scores = np.round(scores, 1).astype(np.float32)
    ids = rng.permutation(np.arange(100, 100 + n))
    answers = (rng.choice(ids, size=int(rng.integers(1, 3)), replace=False) if rng.random() < 0.6
               else np.asarray([9999]))
    return dict(heads=heads, tails=tails, relations=relations, labels=(rng.random(e) < 0.3).astype(np.float32),
                scores=scores, node_entity_ids=ids, node_embedding_ids=rng.integers(1, 500, size=n),
                start_entity_ids=rng.choice(ids, size=int(rng.integers(1, 3)), replace=False),
                answer_entity_ids=np.concatenate([answers, answers[:1]]))


SETTINGS = [
    dict(edge_top_k=8, score_mode="logits", allow_empty_answer=True),
    dict(edge_top_k=8, score_mode="node_softmax", allow_empty_answer=True),
    dict(edge_top_k=500, score_mode="node_softmax", allow_empty_answer=False),
    dict(edge_top_k=5, start_keep_ratio=0.6, start_min_edges=2, start_max_edges=3, score_mode="logits",
         allow_empty_answer=True),
    dict(edge_top_k=6, start_max_edges=0, score_mode="node_softmax", allow_empty_answer=True, compute_pairs=False),
    dict(edge_top_k=10, apply_hop_filter=True, max_hops=1, allow_empty_answer=True),
]


def assert_samples_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _record(s):
    return {"question_id": s.question_id, "num_nodes": s.num_nodes, "edge_head_locals": s.edge_head_locals,
            "edge_scores": s.edge_scores, "edge_labels": s.edge_labels, "answer_entity_ids": s.answer_entity_ids,
            "is_dummy_agent": bool(s.is_dummy_agent), "name": s.sample_id, "extra": [1, 2, 3], "f": 0.5}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_build_agent_sample_matches_jax(seed, ties):
    kw = _random_graph(seed, ties=ties)
    for st in SETTINGS:
        want = jga.build_agent_sample(sample_id="s", question_id=3, settings=jga.AgentSettings(**st), **kw)
        got = tga.build_agent_sample(sample_id="s", question_id=3, settings=tga.AgentSettings(**st), **kw)
        assert_samples_equal(got, want)
        if want is not None:
            got.validate()
            assert tstore.encode_record(_record(got)) == jstore.encode_record(_record(want))


def test_selection_functions_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n, e = int(rng.integers(3, 30)), int(rng.integers(1, 80))
        heads, tails = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
        scores = np.round(rng.normal(size=e), 1 if trial % 2 else 6).astype(np.float32)
        np.testing.assert_array_equal(tga.node_softmax_logit(scores, heads, tails, n),
                                      jga.node_softmax_logit(scores, heads, tails, n))
        for k in (1, 3, e, e + 5):
            np.testing.assert_array_equal(tga.select_topk_edges(scores, k), jga.select_topk_edges(scores, k))
        kw = dict(heads=heads, tails=tails, scores=scores, start_nodes=rng.integers(0, n, size=3), num_nodes=n,
                  keep_ratio=float(rng.random()), min_edges=int(rng.integers(0, 3)), max_edges=int(rng.integers(0, 6)))
        np.testing.assert_array_equal(tga.select_start_edges(**kw), jga.select_start_edges(**kw))
        starts = rng.integers(0, n, size=2)
        np.testing.assert_array_equal(tga._hop_filter(heads, tails, starts, n, 2),
                                      jga._hop_filter(heads, tails, starts, n, 2))


def _agent_samples(count=6):
    out = []
    for seed in range(40):
        a = jga.build_agent_sample(sample_id=f"q{seed}", question_id=seed, settings=jga.AgentSettings(
            edge_top_k=12, allow_empty_answer=True), **_random_graph(seed))
        if a is not None:
            out.append(a)
        if len(out) == count:
            return out
    raise AssertionError("too few agent samples")


def test_agent_store_bytes_and_loads_match_jax(tmp_path):
    samples = _agent_samples()
    meta = {"edge_top_k": 12}
    jart.save_agent_store(samples, tmp_path / "jax", split="validation", settings_meta=meta)
    tart.save_agent_store(samples, tmp_path / "port", split="validation", settings_meta=meta)
    for name in ("data.bin", "ids.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "offsets.npy"), np.load(tmp_path / "jax" / "offsets.npy"))
    jm, tm = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("jax", "port"))
    assert {k: v for k, v in tm.items() if k not in ("producer", "created_at")} == \
        {k: v for k, v in jm.items() if k not in ("producer", "created_at")}
    for drop in (False, True):
        for a, b in zip(tart.load_agent_store(tmp_path / "jax", drop_unreachable=drop),
                        jart.load_agent_store(tmp_path / "port", drop_unreachable=drop), strict=True):
            assert_samples_equal(a, b)
    store = tstore.SampleStore(tmp_path / "port", expected_artifact="g_agent", expected_schema_version=1)
    assert len(store) == len(samples) and "q0" in store
    with pytest.raises(ValueError, match="artifact mismatch"):
        tstore.SampleStore(tmp_path / "port", expected_artifact="other")


def test_agent_sample_validator_rejects_corruption():
    s = _agent_samples(1)[0]
    corruptions = [
        dict(edge_head_locals=s.edge_head_locals[:-1]),
        dict(edge_scores=np.full_like(s.edge_scores, np.nan)),
        dict(start_node_locals=np.empty(0, np.int64)),
        dict(is_dummy_agent=not s.is_dummy_agent),
        dict(pair_shortest_len=np.zeros(s.pair_start_local.shape[0] + 1, np.int64)),
    ]
    for bad in corruptions:
        for lib in (jga, tga):
            with pytest.raises(ValueError):
                lib.AgentSample(**{**dataclasses.asdict(s), **bad}).validate()


def _rank_samples(seed, count=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        e = int(rng.integers(1, 40))
        out.append({"scores": np.round(rng.normal(size=e), 1), "labels": (rng.random(e) < 0.2).astype(np.float32),
                    "answer_ids": rng.integers(0, 10, size=int(rng.integers(0, 3))),
                    "head_ids": rng.integers(0, 10, size=e), "tail_ids": rng.integers(0, 10, size=e)})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ranking_metrics_match_jax(seed):
    samples = _rank_samples(seed)
    ks = (1, 3, 5, 10, 100)
    assert (trank.compute_ranking_metrics(samples, ks).as_flat_dict("r/")
            == jrank.compute_ranking_metrics(samples, ks).as_flat_dict("r/"))
    assert trank.compute_answer_recall(samples, ks) == jrank.compute_answer_recall(samples, ks)
    assert trank.compute_answer_hit(samples, ks) == jrank.compute_answer_hit(samples, ks)
    assert trank.normalize_k_values([0, 5, 3, 5]) == jrank.normalize_k_values([0, 5, 3, 5])
    monitors = (trank.FeatureMonitor(), jrank.FeatureMonitor())
    rng = np.random.default_rng(seed)
    for m in monitors:
        for s in samples:
            m.update(s["scores"], s["labels"], features=rng.normal(size=(len(s["scores"]), 4)), mask=s["labels"] >= 0)
        rng = np.random.default_rng(seed)
    assert monitors[0].compute() == monitors[1].compute()


def _chain_graph(seed):
    rng = np.random.default_rng(seed)
    n, e = int(rng.integers(4, 14)), int(rng.integers(3, 30))
    return dict(num_nodes=n, heads=rng.integers(0, n, size=e), tails=rng.integers(0, n, size=e),
                relations=rng.integers(0, 6, size=e), scores=np.round(rng.normal(size=e), 1),
                node_entity_ids=rng.permutation(1000 + np.arange(n)),
                start_nodes=rng.integers(-1, n + 1, size=int(rng.integers(1, 3))))


CHAIN_SETTINGS = [dict(), dict(max_chain_length=2, min_chain_length=2), dict(allow_backward=False),
                  dict(forbid_edge_revisit=False, max_chain_length=2), dict(forbid_node_revisit=True),
                  dict(max_branch_per_node=2), dict(max_branch_per_node=-3), dict(max_total_chains=7),
                  dict(max_chains_per_sample=3)]


@pytest.mark.parametrize("seed", range(5))
def test_chains_match_jax(seed):
    g = _chain_graph(seed)
    for st in CHAIN_SETTINGS:
        assert (tchains.build_bfs_candidate_chains(**g, settings=tchains.ChainSettings(**st))
                == jchains.build_bfs_candidate_chains(**g, settings=jchains.ChainSettings(**st))), st
    rng = np.random.default_rng(seed)
    e = len(g["heads"])
    acts = np.where(rng.random((6, 4)) < 0.2, -1, rng.integers(0, e, size=(6, 4)))
    dirs = rng.integers(0, 2, size=(6, 4))
    kw = dict(actions_seqs=acts, directions_seqs=dirs, **{k: g[k] for k in ("heads", "tails", "relations", "scores",
                                                                            "node_entity_ids")})
    got, want = tchains.chains_from_rollouts(**kw, max_chains=5), jchains.chains_from_rollouts(**kw, max_chains=5)
    assert got == want
    names = {int(i): f"e{i}" for i in g["node_entity_ids"][::2]}
    rels = {r: f"r{r}" for r in range(3)}
    assert [tchains.textualize_chain(c, id2entity=names, id2relation=rels) for c in got] == \
        [jchains.textualize_chain(c, id2entity=names, id2relation=rels) for c in want]


def test_topk_and_rollout_records_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    e = 30
    kw = dict(sample_id="q", scores=np.round(rng.normal(size=e), 1).astype(np.float32),
              logits_fwd=rng.normal(size=e).astype(np.float32), logits_bwd=rng.normal(size=e).astype(np.float32),
              heads_global=rng.integers(0, 50, size=e), rels=rng.integers(0, 5, size=e),
              tails_global=rng.integers(0, 50, size=e), k_values=(1, 5, 100),
              labels=(rng.random(e) < 0.3).astype(np.float32), answer_entity_ids=np.array([3, 7]),
              question="q?", id2entity={3: "three"}, id2relation={1: "one"})
    records = [tart.topk_record_for_sample(**kw)]
    assert records == [jart.topk_record_for_sample(**kw)]
    tart.write_topk_edges(records, tmp_path / "port", split="validation", k_values=(1, 5, 100))
    jart.write_topk_edges(records, tmp_path / "jax", split="validation", k_values=(1, 5, 100))
    assert (tmp_path / "port" / "validation.jsonl").read_bytes() == (tmp_path / "jax" / "validation.jsonl").read_bytes()
    tart.validate_manifest(tmp_path / "jax", artifact=jart.TOPK_ARTIFACT, split="validation")
    jart.validate_manifest(tmp_path / "port", artifact=tart.TOPK_ARTIFACT, split="validation")

    s = _agent_samples(1)[0]
    acts = np.where(rng.random((5, 4)) < 0.3, -1, rng.integers(0, s.num_edges, size=(5, 4)))
    rkw = dict(actions_local=acts, directions=rng.integers(0, 2, size=(5, 4)), answer_hits=rng.random(5) < 0.5,
               id2entity={int(i): "x" for i in s.node_entity_ids}, id2relation={0: "r0"})
    rec = tart.rollout_record_for_sample(s, **rkw)
    assert rec == jart.rollout_record_for_sample(s, **rkw)
    tart.write_rollout_records([rec], tmp_path / "port_ro", split="test", num_rollouts=5)
    jart.write_rollout_records([rec], tmp_path / "jax_ro", split="test", num_rollouts=5)
    assert (tmp_path / "port_ro" / "test.jsonl").read_bytes() == (tmp_path / "jax_ro" / "test.jsonl").read_bytes()
    with pytest.raises(ValueError, match="artifact"):
        tart.validate_manifest(tmp_path / "port_ro", artifact=tart.TOPK_ARTIFACT, split="test")
