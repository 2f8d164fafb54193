"""Port vs JAX at the CLI: ``eval_retriever`` and ``eval_gflownet``, and the
port's own stage chain on the CPU.

* Both ``eval_retriever`` tasks read one f32 checkpoint (saved by each
  package's ``save_checkpoint``): the g_agent store records, the
  ``eval_retriever/<split>.jsonl`` records and ``metrics.json`` (timers
  excluded) are equal, with logits and scores at rtol 1e-4.  The store's
  edge selection cuts the top ``edge_top_k`` calibrated scores, and the
  port's f32 scores differ from JAX's by ~1e-6, so the rule for edge sets
  is: equal, or every differing edge lies within 1e-5 of the k-th
  calibrated score in both packages.
* Both ``eval_gflownet`` tasks read one converted checkpoint with
  ``gflownet.eval_temperature=0`` (greedy rollouts are deterministic):
  ``metrics.json`` and the rollout records are equal (the SubTB loss of
  the greedy rollouts at rtol 1e-3: see the test).
* The port's ``train_retriever -> eval_retriever -> train_gflownet ->
  eval_gflownet`` chain runs on the CPU (``device=cpu``).
"""

import json
import pathlib

import jax
import numpy as np
import pytest

from evi_rag_tpu import cli as jcli
from evi_rag_tpu.models.retriever import Retriever as JRetriever
from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu.utils.config import load_config as jload
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.data.g_agent import node_softmax_logit
from evi_rag_tpu_torch.eval.artifacts import load_agent_store
from evi_rag_tpu_torch.train import checkpoint as tck
from evi_rag_tpu_torch.utils.config import ConfigError, load_config as tload

from _torch_gfn_common import agent_setup, configs, perturbed_params

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
DIM = 32
COMMON = ["dataset.num_samples=12", f"dataset.emb_dim={DIM}", "dataset.max_nodes=16",
          f"retriever.model.emb_dim={DIM}", f"retriever.model.hidden_dim={DIM}", "retriever.model.dropout_p=0.0",
          "retriever.train.k_values=[1,5,10,1000]", "eval.g_agent.edge_top_k=12"]
TIMERS = "/phase/"
TIE = 1e-5


def _run(lib, load, task, overrides, run_dir):
    cfg = load(CONFIGS, task, overrides)
    cfg["task_name"], cfg["_configs_dir"] = task, CONFIGS
    run_dir.mkdir(parents=True, exist_ok=True)
    return lib.TASKS[task](cfg, run_dir=run_dir)


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_retriever")
    cfg = jload(CONFIGS, "eval_retriever", COMMON)
    ds = cfg["dataset"]
    from evi_rag_tpu.data import feeder as jfeed
    from evi_rag_tpu.data.synthetic import make_synthetic_dataset

    synth = make_synthetic_dataset(num_samples=4, emb_dim=DIM, max_nodes=int(ds["max_nodes"]), seed=1)
    jb = jfeed.collate_retriever(synth.samples, entity_emb=synth.entity_emb, relation_emb=synth.relation_emb,
                                 question_emb=synth.question_emb, bucket=jfeed.fixed_bucket_for(synth.samples, 4))
    model = JRetriever(emb_dim=DIM, hidden_dim=DIM, dropout_p=0.0)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), jb))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.2 * rng.normal(size=x.shape)).astype(np.float32), params)
    meta = {"parity_meta": model.parity_meta()}
    jck.save_checkpoint(tmp / "jax_ckpt", params, meta=meta)
    tck.save_checkpoint(tmp / "port_ckpt", params, meta=meta)
    out = {}
    for name, lib, load, extra in (("jax", jcli, jload, []), ("port", tcli, tload, ["device=cpu"])):
        art = tmp / name / "art"
        ov = [*COMMON, *extra, f"retriever.ckpt={tmp / f'{name}_ckpt'}", f"eval.artifacts_dir={art}",
              "eval.splits=[validation,test]"]
        out[name] = (_run(lib, load, "eval_retriever", ov, tmp / name / "run"), art)
    out["params"], out["tmp"] = params, tmp
    return out


def _edge_triples(s):
    ids = s.node_entity_ids
    return {(int(ids[h]), int(r), int(ids[t])): i
            for i, (h, r, t) in enumerate(zip(s.edge_head_locals, s.edge_relations, s.edge_tail_locals))}


def test_eval_retriever_metrics_match_jax(both_evals):
    (jm, _), (tm, _) = both_evals["jax"], both_evals["port"]
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        if TIMERS in k:
            continue
        assert tm[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    assert jm["validation/num_agent_samples"] > 0


def test_eval_retriever_topk_records_match_jax(both_evals):
    (_, jart), (_, tart) = both_evals["jax"], both_evals["port"]
    for split in ("validation", "test"):
        jl = [json.loads(x) for x in (jart / "eval_retriever" / f"{split}.jsonl").read_text().splitlines()]
        tl = [json.loads(x) for x in (tart / "eval_retriever" / f"{split}.jsonl").read_text().splitlines()]
        assert len(tl) == len(jl) > 0
        for j, t in zip(jl, tl):
            assert {k: v for k, v in t.items() if k != "triplets_by_k"} == \
                {k: v for k, v in j.items() if k != "triplets_by_k"}
            for k, jrows in j["triplets_by_k"].items():
                trows = t["triplets_by_k"][k]
                assert [r["edge_idx"] for r in trows] == [r["edge_idx"] for r in jrows], (j["sample_id"], k)
                for tr, jr in zip(trows, jrows):
                    for f in ("score", "logit_fwd", "logit_bwd"):
                        assert tr[f] == pytest.approx(jr[f], rel=1e-4, abs=1e-5), f
                    assert {f: v for f, v in tr.items() if f not in ("score", "logit_fwd", "logit_bwd")} == \
                        {f: v for f, v in jr.items() if f not in ("score", "logit_fwd", "logit_bwd")}
        jman = json.loads((jart / "eval_retriever" / f"{split}.manifest.json").read_text())
        tman = json.loads((tart / "eval_retriever" / f"{split}.manifest.json").read_text())
        assert {k: v for k, v in tman.items() if k not in ("producer", "created_at")} == \
            {k: v for k, v in jman.items() if k not in ("producer", "created_at")}


def _calibrated(record, sample_by_id):
    """(raw edge order, calibrated scores) of one sample from its top-k
    record (k = 1000 lists every edge)."""
    rows = max(record["triplets_by_k"].values(), key=len)
    s = sample_by_id[record["sample_id"]]
    raw = np.zeros(s.edge_index.shape[1], np.float32)
    for r in rows:
        raw[r["edge_idx"]] = r["score"]
    return node_softmax_logit(raw, s.edge_index[0], s.edge_index[1], s.num_nodes)


def test_eval_retriever_stores_match_jax_under_the_tie_rule(both_evals):
    (_, jart), (_, tart) = both_evals["jax"], both_evals["port"]
    k = 12
    cfg = tload(CONFIGS, "eval_retriever", [*COMMON, "device=cpu"])
    for split in ("validation", "test"):
        samples = {s.sample_id: s for s in tcli._load_split(cfg, split)[0]}
        recs = {}
        for name, art in (("jax", jart), ("port", tart)):
            recs[name] = {json.loads(x)["sample_id"]: json.loads(x)
                          for x in (art / "eval_retriever" / f"{split}.jsonl").read_text().splitlines()}
        jst = load_agent_store(jart / "g_agent" / split)
        tst = load_agent_store(tart / "g_agent" / split)
        assert [s.sample_id for s in tst] == [s.sample_id for s in jst] and jst
        for j, t in zip(jst, tst):
            je, te = _edge_triples(j), _edge_triples(t)
            if je.keys() != te.keys():
                s = samples[j.sample_id]
                ids = s.node_entity_ids
                for name in ("jax", "port"):
                    cal = _calibrated(recs[name][j.sample_id], samples)
                    kth = np.sort(cal)[::-1][min(k, cal.size) - 1]
                    for trip in je.keys() ^ te.keys():
                        edges = [i for i in range(cal.size) if (int(ids[s.edge_index[0][i]]),
                                                                 int(s.edge_relations[i]),
                                                                 int(ids[s.edge_index[1][i]])) == trip]
                        assert any(abs(cal[i] - kth) <= TIE for i in edges), (name, trip)
                continue
            for f in ("num_nodes", "is_dummy_agent", "is_answer_reachable", "question_id"):
                assert getattr(t, f) == getattr(j, f), f
            for f in ("edge_head_locals", "edge_tail_locals", "edge_relations", "edge_labels", "node_entity_ids",
                      "node_embedding_ids", "start_entity_ids", "answer_entity_ids", "start_node_locals",
                      "answer_node_locals", "pair_start_local", "pair_answer_local", "pair_shortest_len"):
                np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
            np.testing.assert_allclose(t.edge_scores, j.edge_scores, rtol=1e-4, atol=1e-5)


def test_eval_gflownet_clis_match_jax_greedy(both_evals):
    tmp, (_, jart) = both_evals["tmp"], both_evals["jax"]
    rparams = both_evals["params"]
    bundle = jck.export_retriever_features(rparams["params"], {"use_topic_pe": 1, "num_topics": 2, "dde_rounds": 2,
                                                               "dde_reverse_rounds": 2})
    jcfg, _ = configs(hidden_dim=DIM, max_steps=3)
    # Noise on every leaf, so that greedy rollouts take edges.
    gparams = perturbed_params(jcfg, jgt.build_modules(jcfg), agent_setup(emb=DIM), seed=1)
    rmeta = {"parity_meta": bundle["parity_meta"], "retriever_ckpt_sha256": "x"}
    jck.save_checkpoint(tmp / "jax_gfn", {"gflownet": gparams, "retriever_bundle": bundle},
                        meta={"retriever_meta": rmeta})
    tcli.save_gflownet_checkpoint(tmp / "port_gfn", gparams, bundle, rmeta, 0.0)
    out = {}
    ov = [*COMMON, f"gflownet.g_agent_dir={jart / 'g_agent'}", f"gflownet.hidden_dim={DIM}",
          "gflownet.eval_temperature=0.0", "gflownet.eval_rollouts=3", "gflownet.eval_rollout_prefixes=[1,3]",
          "eval.splits=[validation,test]"]
    for name, lib, load, extra in (("jax", jcli, jload, []), ("port", tcli, tload, ["device=cpu"])):
        art = tmp / f"gfn_{name}"
        out[name] = (_run(lib, load, "eval_gflownet", [*ov, *extra, f"gflownet.ckpt={tmp / f'{name}_gfn'}",
                                                       f"eval.artifacts_dir={art}"], tmp / f"gfn_run_{name}"), art)
    (jm, jdir), (tm, tdir) = out["jax"], out["port"]
    assert tm.keys() == jm.keys()
    for k, v in jm.items():
        # At temperature 0 the logits are divided by MIN_TEMPERATURE = 1e-5:
        # a 1e-7 relative difference of a logit becomes ~1e-2 in a log-prob,
        # so the SubTB loss of the greedy rollouts holds at rtol 1e-3; the
        # hits, lengths, rewards and rollouts are exact.
        rel = 1e-3 if k.endswith("loss") else 1e-6
        assert tm[k] == pytest.approx(v, rel=rel, abs=1e-6), k
    for split in ("validation", "test"):
        jl = (jdir / "eval_gflownet" / f"{split}.jsonl").read_text().splitlines()
        tl = (tdir / "eval_gflownet" / f"{split}.jsonl").read_text().splitlines()
        assert [json.loads(x) for x in tl] == [json.loads(x) for x in jl]
    assert any(r["actions"] for x in jl for r in json.loads(x)["rollouts"])


def test_port_cli_chain_on_cpu(tmp_path):
    art = tmp_path / "art"
    common = ["experiment=quick_synthetic", "device=cpu", f"eval.artifacts_dir={art}",
              f"gflownet.g_agent_dir={art / 'g_agent'}"]
    _run(tcli, tload, "train_retriever", [*common, f"retriever.train.ckpt_dir={tmp_path / 'ckpt' / 'r'}"],
         tmp_path / "r1")
    best = tmp_path / "ckpt" / "r" / "best"
    rmeta = json.loads((best / "meta.json").read_text())
    for split in ("validation", "train"):
        m = _run(tcli, tload, "eval_retriever", [*common, f"retriever.ckpt={best}", f"eval.splits=[{split}]",
                                                  "eval.g_agent.edge_top_k=50"], tmp_path / f"e_{split}")
        assert m[f"{split}/num_agent_samples"] > 0
        ga = json.loads((art / "g_agent" / split / "manifest.json").read_text())
        assert {"edge_top_k", "max_hops", "apply_hop_filter", "start_max_edges", "score_mode"} <= set(ga["settings"])
        assert (art / "eval_retriever" / f"{split}.manifest.json").exists()
    with pytest.raises(ConfigError, match="retriever.ckpt"):
        _run(tcli, tload, "train_gflownet", common, tmp_path / "g0")
    m3 = _run(tcli, tload, "train_gflownet", [*common, f"retriever.ckpt={best}",
                                               f"gflownet.ckpt_dir={tmp_path / 'ckpt' / 'g'}"], tmp_path / "g1")
    assert np.isfinite(m3["best_score"]) and (tmp_path / "g1" / "metrics.jsonl").exists()
    gmeta = json.loads((tmp_path / "ckpt" / "g" / "best" / "meta.json").read_text())
    assert gmeta["retriever_meta"]["retriever_ckpt_sha256"] == rmeta["params_sha256"]
    m4 = _run(tcli, tload, "eval_gflownet", [*common, f"gflownet.ckpt={tmp_path / 'ckpt' / 'g' / 'best'}",
                                              "eval.splits=[validation]"], tmp_path / "g2")
    assert "validation/answer_hit@1" in m4
    rec = json.loads((art / "eval_gflownet" / "validation.jsonl").read_text().splitlines()[0])
    assert "candidate_chains" in rec and rec["num_rollouts"] >= 1
    # A checkpoint whose recorded feature geometry disagrees is refused
    # before any compute.
    gmeta["retriever_meta"]["parity_meta"]["dde_rounds"] = 3
    (tmp_path / "ckpt" / "g" / "best" / "meta.json").write_text(json.dumps(gmeta))
    with pytest.raises(ValueError, match="parity_meta mismatch"):
        _run(tcli, tload, "eval_gflownet", [*common, f"gflownet.ckpt={tmp_path / 'ckpt' / 'g' / 'best'}",
                                             "eval.splits=[validation]"], tmp_path / "g3")


def test_eval_dataset_variants_loop(tmp_path):
    _run(tcli, tload, "train_retriever", ["experiment=quick_synthetic", "device=cpu",
                                          f"retriever.train.ckpt_dir={tmp_path / 'ckpt'}"], tmp_path / "r")
    m = _run(tcli, tload, "eval_retriever", [
        "experiment=quick_synthetic", "device=cpu", f"retriever.ckpt={tmp_path / 'ckpt' / 'best'}",
        "eval.splits=[validation]", "eval.g_agent.edge_top_k=20", "eval.datasets=[synthetic, synthetic]",
        f"eval.artifacts_dir={tmp_path / 'art'}"], tmp_path / "dual")
    assert any(k.startswith("synthetic/validation/") for k in m) and (tmp_path / "dual" / "metrics.json").exists()
    metric_only = _run(tcli, tload, "eval_retriever", [
        "experiment=quick_synthetic", "device=cpu", f"retriever.ckpt={tmp_path / 'ckpt' / 'best'}",
        "eval.splits=[validation]", "eval.write_artifacts=false", "eval.ranking_metrics=false"], tmp_path / "mo")
    assert "validation/edge/recall@5" in metric_only and "validation/num_agent_samples" not in metric_only
