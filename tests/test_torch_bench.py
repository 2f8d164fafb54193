"""Port vs JAX: the port's bench (``python -m evi_rag_tpu_torch.bench``) and
the GFlowNet profiler its GFlowNet sections build on.

(a) ``make_bundle`` and ``build_inputs`` are bit for bit ``bench.py``'s.
(b) ``fused_kernel_mfu`` counts ``bench.py``'s FLOPs over the H100's bf16
    peak (port x 989 = JAX x 197); one 128-query pass over 131,072
    candidates is ``chip_smoke.pooled_bounds``' kernel-2 bound; ``auto_bq``
    is JAX's.
(c) ``bench_query`` at a tiny shape returns the top-k of JAX's
    ``ops.query.query_topk`` on the same numpy inputs, by
    ``tests/test_torch_pooled_query.py``'s set rule (the plain engine: all
    but one id shared, 0.01 + 1%; the kernel engines' plain versions on the
    CPU: all but two, 0.02 + 2%, the same file's rule for the wrappers).
(d) ``profile_gfn_step._build`` collates the agent batch JAX's pieces
    collate at the JAX script's seeds, and the bench's GFlowNet sections
    step on that batch.
(e) Every section runs on the CPU at a tiny size and reports its keys.
(f) The keys of a run are ``bench.py``'s (``BENCH_PY_KEYS``, below), but for
    the two renames, plus ``device``, ``power_limit_w``, ``launches`` and
    ``checks``.
(g) A section that raises fails the run: ``run_cli`` returns 1, prints the
    structured error line and keeps the finished sections' details.  JAX's
    bench returns 0 here (``tests/test_driver_surfaces.py``); the port's
    may not.
(h) With no card and no ``--device cpu`` the entry point raises.
"""

import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.data.g_agent import AgentSettings, build_agent_sample
from evi_rag_tpu.data.synthetic import make_synthetic_dataset as j_synth
from evi_rag_tpu.ops import query as jq
from evi_rag_tpu_torch import bench as tbench
from evi_rag_tpu_torch.data.feeder import Bucket
from evi_rag_tpu_torch.scripts import profile_gfn_step as pg
from test_torch_pooled_query import _overlap

EMB = 16
# Every section at a small width.  batch stays 128 so that the latency key is
# the headline's (query_latency_ms_batch128).
TINY = tbench.Sizes(dim=16, candidates=512, batch=128, batch_small=8, k=16, chunk=128, cpu_reduced=256,
                    candidates_1m=1024, build_vocab=300, build_rels=17, build_m=1000, knn_rows=500, knn_batch=4,
                    train_samples=4, train_max_nodes=12, train_bucket=Bucket(graphs=5, nodes=128, edges=512),
                    gfn_graphs=3, gfn_graphs_wide=4, serve_questions=6, serve_questions_realistic=4)

# bench.py's DETAILS keys of a run in which every section finishes (its main,
# bench.py:770-884; the serve keys from _serve_keys with the prefixes "serve"
# and "serve_realistic").
_SERVE = ("qps_all_passes", "qps_best", "pack_s", "dispatch_s", "drain_s", "index_build_s", "drain_frac",
          "dispatch_frac")
BENCH_PY_KEYS = {
    "engine", "query_throughput_qps", "headline_batch", "query_latency_ms_batch128", "query_qps_batch8",
    "cpu_reference_qps", "mfu_fused_131k", "index_build_1m_candidates_ms", "query_qps_1m_candidates_fused",
    "query_qps_1m_candidates_xla", "fused_vs_xla_1m", "mfu_fused_1m", "knn_qps_262k_rows_d1024",
    "knn_qps_262k_rows_d1024_approx", "train_step_graphs_per_sec", "gflownet_step_graphs_per_sec",
    "gflownet_step_graphs_per_sec_cached_embed", "gflownet_step_graphs_per_sec_bf16_policy",
    "gflownet_step_graphs_per_sec_no_precompute", "gflownet_step_graphs_per_sec_sts",
    "gflownet_step_graphs_per_sec_sts_bf16", "gflownet_step_graphs_per_sec_b64_bf16",
    "gflownet_step_graphs_per_sec_b64_bf16_dots", "gflownet_step_graphs_per_sec_b64_bf16_sts",
    "gflownet_step_graphs_per_sec_b64_bf16_sts_dots", "serve_qps_warm_256q_d1024",
    "serve_qps_realistic_1024q_d1024", *(f"serve_{k}" for k in _SERVE), *(f"serve_realistic_{k}" for k in _SERVE),
}
RENAMED = {"query_qps_1m_candidates_xla": "query_qps_1m_candidates_plain", "fused_vs_xla_1m": "fused_vs_plain_1m"}
ADDED = {"device", "power_limit_w", "launches", "checks"}
# Each section and the keys it writes (the launches are recorded per section).
SECTIONS = {
    "headline": ("query_throughput_qps", "query_latency_ms_batch128", "mfu_fused_131k", "cpu_reference_qps"),
    "batch8": ("query_qps_batch8",),
    "index build": ("index_build_1m_candidates_ms",),
    "1m": ("query_qps_1m_candidates_fused", "query_qps_1m_candidates_plain", "fused_vs_plain_1m", "mfu_fused_1m"),
    "knn": ("knn_qps_262k_rows_d1024", "knn_qps_262k_rows_d1024_approx"),
    "train step": ("train_step_graphs_per_sec",),
    "gflownet step": tuple(k for k in BENCH_PY_KEYS if k.startswith("gflownet_step")),
    "serve surface": ("serve_qps_warm_256q_d1024",) + tuple(f"serve_{k}" for k in _SERVE),
    "serve realistic": ("serve_qps_realistic_1024q_d1024",) + tuple(f"serve_realistic_{k}" for k in _SERVE),
}


def _assert_trees_equal(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        assert jtree.keys() == ttree.keys(), path
        for k in jtree:
            _assert_trees_equal(jtree[k], ttree[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(jtree):
        for f in dataclasses.fields(jtree):
            _assert_trees_equal(getattr(jtree, f.name), getattr(ttree, f.name), f"{path}.{f.name}")
    elif jtree is None:
        assert ttree is None, path
    else:
        got = ttree.numpy() if isinstance(ttree, torch.Tensor) else np.asarray(ttree)
        np.testing.assert_array_equal(got, np.asarray(jtree), err_msg=path)
        assert got.dtype == np.asarray(jtree).dtype, path


def _jax_agent_batch(num_graphs: int, emb: int):
    """The JAX script's agent batch (``scripts/profile_gfn_step.py::_build``)
    from JAX's pieces, at embedding width ``emb``."""
    ds = j_synth(num_samples=num_graphs, emb_dim=emb, max_nodes=48, seed=5)
    rng = np.random.default_rng(0)
    agents = []
    for s in ds.samples:
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
            relations=s.edge_relations, labels=s.edge_labels.astype(np.float32),
            scores=rng.normal(size=s.edge_index.shape[1]).astype(np.float32) + 2 * s.edge_labels,
            node_entity_ids=np.arange(1000, 1000 + s.num_nodes), node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=1000 + s.topic_locals, answer_entity_ids=1000 + s.answer_locals,
            settings=AgentSettings(edge_top_k=200, score_mode="logits"))
        if a is not None:
            agents.append(a)
    agents = agents[:num_graphs]
    bucket = jfeed.fixed_agent_bucket(agents, num_graphs)
    return bucket, jfeed.collate_agent(agents, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                                       question_emb=ds.question_emb, bucket=bucket)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny sections' ops are far too small for torch's thread pool: with
    one pool of a thread per core in each of the suite's parallel workers,
    a GFlowNet step here took ~100x its time alone (oversubscribed cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One ``run_cli`` of every section on the CPU at ``TINY``: (exit code,
    stdout lines, details, the batches ``profile_gfn_step._build`` made)."""
    path = tmp_path_factory.mktemp("bench") / "details.json"
    built = []
    real = pg._build

    def recording_build(*args, **kw):
        out = real(*args, **kw)
        built.append(out[3])
        return out

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(pg, "_build", recording_build)
        mp.setenv("EVI_BENCH_GFN_AB", "1")
        mp.setenv("EVI_BENCH_GFN_KNOBS", "1")
        rc = tbench.run_cli(["--device", "cpu", "--details", str(path)], sizes=TINY)
    return rc, out.getvalue().strip().splitlines(), json.loads(path.read_text()), built


# ---------------------------------------------------------------- (a), (b)

@pytest.mark.parametrize("seed", [0, 11])
def test_inputs_and_bundle_match_bench_py(seed):
    _assert_trees_equal(jbench.make_bundle(32, 48, 20, seed=seed), tbench.make_bundle(32, 48, 20, seed=seed))
    want, got = jbench.build_inputs(100, 32, 20, 4, seed=seed), tbench.build_inputs(100, 32, 20, 4, seed=seed)
    _assert_trees_equal(want, got)


def test_fused_kernel_mfu_counts_bench_py_flops():
    for args in [(239.54, 131072, 1024, 1024, 128), (30.0, 1_048_576, 1024, 1024, 128), (77.0, 512, 64, 96, 8)]:
        assert tbench.fused_kernel_mfu(*args) * 989 == pytest.approx(jbench.fused_kernel_mfu(*args) * 197, rel=1e-12)
    # One 128-query pass a second: the MFU is the bound's share of a second.
    bound_ms = chip_smoke.pooled_bounds(128, 131072, 1024, 1024, 20, 100)["query_topk_fused"][0]
    assert tbench.fused_kernel_mfu(128.0, 131072, 1024, 1024, tbench.auto_bq(128)) * 1e3 == pytest.approx(bound_ms,
                                                                                                          rel=1e-12)
    assert bound_ms == pytest.approx(71.985, abs=5e-4)
    assert [tbench.auto_bq(b) for b in range(1, 257)] == [jbench.auto_bq(b) for b in range(1, 257)]


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("engine, slack, tol", [("plain", 1, 0.01), ("fused", 2, 0.02), ("per_query", 2, 0.02)])
def test_bench_query_matches_jax_query_topk(engine, slack, tol):
    m, d, s, b, k = 512, 64, 20, 8, 16
    bundle = jbench.make_bundle(d, d, s, seed=2)
    ins = jbench.build_inputs(m, d, s, b, seed=2)
    run = tbench.bench_query(bundle, ins, k=k, chunk=128, iters=1, engine=engine, check_queries=4, device="cpu")
    index = jq.TripleIndex(*(jnp.asarray(ins[n]) for n in ("head", "rel", "tail", "struct")))
    jv, ji = jq.query_topk(jax.tree.map(jnp.asarray, bundle), jnp.asarray(ins["q"]), index, k=k, chunk=128)
    assert run.vals.shape == (b, k) and run.ids.dtype == torch.int32
    _overlap(np.asarray(jv), np.asarray(ji), run.vals.numpy(), run.ids.numpy(), slack=slack, tol=tol)
    assert run.qps > 0 and run.latency_s > 0
    if engine == "plain":
        assert run.check is None
    else:  # on the CPU the wrapper is its plain version: the check holds exactly
        assert run.check["queries"] == 4 and run.check["max_abs_err"] == 0.0 and run.check["differing_ids"] == 0


def test_hold_to_plain_refuses_a_wrong_top_k():
    plain = torch.tensor([[0.9, 0.5, 0.1, 0.8]])
    assert tbench.hold_to_plain(torch.tensor([[0.9, 0.8]]), torch.tensor([[0, 3]]), plain, 2) == (0.0, 0)
    with pytest.raises(AssertionError, match="near-tie"):
        tbench.hold_to_plain(torch.tensor([[0.9, 0.5]]), torch.tensor([[0, 1]]), plain, 2)
    with pytest.raises(AssertionError, match="max score error"):
        tbench.hold_to_plain(torch.tensor([[0.9, 0.7]]), torch.tensor([[0, 3]]), plain, 2)


@pytest.mark.parametrize("questions, realistic, held, groups", [(4, True, 4, 1), (32, False, 16, 1)])
def test_bench_serve_surface_holds_kernel_buckets_to_plain(questions, realistic, held, groups):
    # At D = 64 the kernels take the shape.  Every realistic bucket has m_pad
    # >= 256; of 32 toy questions, the 16 with the most edges form the one
    # such bucket, and the other 16 take the plain bf16 scorer, unchecked.
    stats, all_qps, best, passes, check = tbench.bench_serve_surface(questions, 64, 16, realistic=realistic,
                                                                     device="cpu")
    assert passes == 6 and len(all_qps) == 5 and best == max(all_qps) and stats.num_questions == questions
    assert check == {"questions": held, "groups": groups, "max_abs_err": 0.0, "swapped": 0,
                     "atol": tbench.CHECK_ATOL, "tie_tol": tbench.CHECK_TIE_TOL}


def test_hold_serve_to_plain_refuses_a_wrong_top_k():
    from evi_rag_tpu_torch.serving import ServeResult

    sample = type("Sample", (), {"sample_id": "q0", "edge_index": np.zeros((2, 4), np.int64)})()

    def res(ids, scores):
        return ServeResult("q0", 0, np.array(ids), np.array(scores, np.float32))

    full = res([0, 3, 1, 2], [0.9, 0.8, 0.5, 0.1])
    assert tbench.hold_serve_to_plain([sample], [res([0, 3], [0.9, 0.8])], [full])[1:] == (0, 0.0)
    with pytest.raises(AssertionError, match="near-tie"):
        tbench.hold_serve_to_plain([sample], [res([0, 1], [0.9, 0.5])], [full])
    with pytest.raises(AssertionError, match="score error"):
        tbench.hold_serve_to_plain([sample], [res([0, 3], [0.9, 0.7])], [full])
    with pytest.raises(AssertionError, match="plain ranking has 2 of 4"):
        tbench.hold_serve_to_plain([sample], [res([0, 3], [0.9, 0.8])], [res([0, 3], [0.9, 0.8])])


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("graphs", [2, 4])
def test_profile_build_collates_jax_agent_batch(graphs):
    cfg, mods, bundle, batch, params, tx, state, step = pg._build(graphs, emb=EMB, device="cpu")
    jbucket, jbatch = _jax_agent_batch(graphs, EMB)
    _assert_trees_equal(jbatch, batch)
    assert (batch.graph.num_graphs, batch.graph.num_nodes, batch.graph.num_edges) == (
        jbucket.graphs, jbucket.nodes, jbucket.edges)
    assert (cfg.hidden_dim, cfg.max_steps, cfg.num_train_rollouts, cfg.bc_weight, cfg.total_steps, cfg.dropout,
            cfg.remat_policy, cfg.optimizer.name, cfg.optimizer.learning_rate) == (
        EMB, 3, 4, 0.5, 100, 0.1, False, "adamw", 1e-4)
    assert bundle["features"]["state_net_0"]["kernel"].shape == (3 * EMB + 1, EMB)
    _, m = step(state, batch)
    assert math.isfinite(float(m["loss"]))


def test_profile_gfn_step_times_every_stage_on_cpu(tmp_path, capsys):
    ms = pg.profile(graphs=2, emb=EMB, iters=1, device="cpu", trace=str(tmp_path / "trace"))
    stages = {"frozen embed", "1 rollout fwd", "rollouts + loss fwd", "fwd+bwd (grad)", "optimizer apply",
              "full step (cached embed)", "full step (embed inline)"}
    assert set(ms) == stages | {f"full step ({label})" for label, _ in pg.STS_VARIANTS}
    assert all(math.isfinite(v) and v > 0 for v in ms.values())
    out = capsys.readouterr().out
    assert "FULL step (sts_remat_bf16)" in out and "bwd-only estimate" in out
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_crossover_sweep_on_cpu(capsys):
    from evi_rag_tpu_torch.scripts import measure_fused_crossover

    rows = measure_fused_crossover.main(dim=64, widths=(8, 256), iters=1, device="cpu")
    assert [(r["m_pad"], r["k"]) for r in rows] == [(8, 8), (256, 100)]
    assert all(r["plain_ms"] > 0 and r["fused_ms"] > 0 for r in rows)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["backend"] == "cpu" and last["crossover_m_pad"] in (None, 8, 256)


def test_bench_gflownet_sections_step_the_jax_batch(tiny_run):
    built = tiny_run[3]
    assert [b.graph.num_graphs - 1 for b in built] == [TINY.gfn_graphs, TINY.gfn_graphs_wide]
    for graphs, batch in zip((TINY.gfn_graphs, TINY.gfn_graphs_wide), built):
        _assert_trees_equal(_jax_agent_batch(graphs, TINY.dim)[1], batch)


# ---------------------------------------------------------------- (e), (f)

def _finite(x):
    return all(_finite(v) for v in x) if isinstance(x, list) else math.isfinite(x)


def test_bench_run_on_cpu_ends_with_the_result_line(tiny_run):
    rc, lines, details, _ = tiny_run
    assert rc == 0
    line = json.loads(lines[-1])
    assert line["metric"] == jbench.METRIC_NAME == tbench.METRIC_NAME
    assert line["unit"] == jbench.METRIC_UNIT == tbench.METRIC_UNIT
    assert line["value"] == details["query_throughput_qps"] > 0 and line["vs_baseline"] > 0
    assert (line["device"], line["power_limit_w"]) == (details["device"], details["power_limit_w"]) == ("cpu", None)
    assert details["engine"] == "fused" and details["headline_batch"] == 128
    # On the CPU every wrapper runs its plain version and counts nothing, and
    # the checks against the plain versions hold exactly.
    assert all(not any(v for k, v in row.items() if k != "passes") for row in details["launches"].values())
    assert {name: row.get("passes") for name, row in details["launches"].items()} == {
        "headline": 7, "batch8": 7, "index build": None, "1m": 5, "knn": None, "train step": None,
        "gflownet step": None, "serve surface": 6, "serve realistic": 6}
    checks = details["checks"]
    assert set(checks) == {"headline", "batch8", "1m_fused", "serve", "serve_realistic"}
    assert all(checks[p]["max_abs_err"] == 0.0 and checks[p]["queries"] > 0 for p in ("headline", "batch8", "1m_fused"))
    # The kernels refuse D = 16: every bucket takes the plain bf16 scorer and
    # none is held (test_bench_serve_surface_holds_kernel_buckets_to_plain
    # holds them at D = 64).
    assert checks["serve"]["questions"] == checks["serve_realistic"]["questions"] == 0


@pytest.mark.parametrize("section", list(SECTIONS))
def test_bench_section_reports_its_keys(tiny_run, section):
    details = tiny_run[2]
    assert section in details["launches"]
    for key in SECTIONS[section]:
        assert _finite(details[key]), key


def test_bench_keys_are_bench_py_keys(tiny_run):
    details = tiny_run[2]
    want = {RENAMED.get(k, k) for k in BENCH_PY_KEYS} | ADDED
    assert set(details) == want
    assert set(tbench.DETAIL_KEYS) == want - ADDED
    assert set().union(*SECTIONS.values()) | {"engine", "headline_batch"} == want - ADDED


# ---------------------------------------------------------------- (g), (h)

def test_failing_section_fails_the_run(tmp_path, monkeypatch, capsys):
    def boom(*args, **kw):
        raise RuntimeError("index build failed")

    monkeypatch.setattr(tbench, "bench_index_build", boom)
    path = tmp_path / "out" / "details.json"
    rc = tbench.run_cli(["--device", "cpu", "--details", str(path)], sizes=TINY)
    assert rc == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["error"] == "bench_exception" and "index build failed" in out["detail"]
    assert (out["metric"], out["value"], out["unit"], out["vs_baseline"]) == (
        tbench.METRIC_NAME, None, tbench.METRIC_UNIT, None)
    details = json.loads(path.read_text())
    assert details["error"] == "bench_exception"
    # The sections before the index build finished and are kept; none after
    # it ran.
    for key in SECTIONS["headline"] + SECTIONS["batch8"]:
        assert _finite(details[key]), key
    assert "index build" in details["launches"] and "1m" not in details["launches"]
    assert not any(key in details for key in SECTIONS["index build"] + SECTIONS["1m"] + SECTIONS["knn"])


def test_bench_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "details.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_cli(["--details", str(path)], sizes=TINY)
    assert not path.exists()
