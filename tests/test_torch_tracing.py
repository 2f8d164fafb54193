"""The port's span and counter registry (``utils/profiling.py``) and the
program's spans in the serve engine and the train step, on the CPU.

* Off (no ``torch.profiler`` session): ``span`` hands out one shared
  no-op, ``one_call`` opens no call id, nothing is recorded and no
  ``record_function`` is entered.
* The program's span names are literals, none with the harness's
  ``bench.`` prefix.
* Under a CPU profiler: parents, call ids, self time and counters, and the
  spans are user annotations among the trace's events.
* ``serve_split`` traced: the route counters follow the grouping rule
  (``bucket_width``, ``fused_threshold``; on the CPU the kernel route runs
  its plain version), and results and ``ServeStats`` are those of the
  untraced call.
* One train step traced: its three spans, and a state and loss bit for bit
  the untraced step's.
* ``trace(dir)`` writes ``spans.json`` beside ``trace.json``.
"""

import dataclasses
import json
import pathlib
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evi_rag_tpu_torch import serving
from evi_rag_tpu_torch.data.feeder import collate_stacked, fixed_bucket_for
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
from evi_rag_tpu_torch.models.retriever import Retriever
from evi_rag_tpu_torch.testing import random_bundle
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, flatten_tree
from evi_rag_tpu_torch.train.optim import OptimizerConfig
from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig, create_train_state, make_train_step
from evi_rag_tpu_torch.utils import profiling

DIM = 64
K = 10
GROUP = 4
THRESHOLD = 128


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def small_ds():
    return make_synthetic_dataset(num_samples=24, emb_dim=DIM, max_nodes=48, avg_extra_edges=3.0, seed=5)


@pytest.fixture(scope="module")
def bundle():
    return {"features": bundle_from_numpy(random_bundle(DIM, seed=1)["features"], device="cpu")}


def _serve(bundle, ds, dtype=torch.bfloat16):
    return serving.serve_split(
        bundle, ds.samples, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
        question_emb=ds.question_emb, k=K, num_rounds=2, num_reverse_rounds=2, group_size=GROUP,
        dtype=dtype, fused_threshold=THRESHOLD, device="cpu")


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    assert not profiling.enabled()
    entered = []
    monkeypatch.setattr(profiling, "annotate", lambda name: entered.append(name))
    assert profiling.span("serve.a") is profiling.span("train.b")

    @profiling.one_call
    def body():
        with profiling.span("serve.a"):
            profiling.count("serve.edges.kernel", 3)

    body()
    with profiling.span("kernel.c"):
        pass
    assert entered == []
    assert profiling.totals() == dict(spans={}, counters={})
    assert profiling.REGISTRY.calls == 0


def test_off_adds_no_event_to_a_later_trace():
    with profiling.span("serve.before"):
        torch.ones(2).sum()
    with _cpu_profile() as prof:
        torch.ones(2).sum()
    assert not [e for e in prof.profiler.kineto_results.events() if e.name() == "serve.before"]


def test_span_cost_while_off_is_one_check():
    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("serve.x"):
            pass
    per_span = (time.perf_counter() - t) / n
    assert per_span < 20e-6, per_span  # ~0.3 us measured; generous for a loaded CPU


def test_spans_parents_calls_self_time_and_counters():
    @profiling.one_call
    def first():
        with profiling.span("serve.outer"):
            time.sleep(0.02)
            with profiling.span("serve.inner"):
                time.sleep(0.01)
            profiling.count("serve.edges.kernel", 2)
        with profiling.span("serve.second"):
            pass

    @profiling.one_call
    def second():
        with profiling.span("serve.outer"):
            profiling.count("serve.edges.kernel")

    with _cpu_profile() as prof:
        assert profiling.enabled()
        first()
        second()
        with profiling.span("serve.loose"):
            pass
    assert not profiling.enabled()
    recs = profiling.REGISTRY.spans
    assert [r["name"] for r in recs] == ["serve.outer", "serve.inner", "serve.second", "serve.outer", "serve.loose"]
    assert [r["parent"] for r in recs] == [-1, 0, -1, -1, -1]
    assert [r["call"] for r in recs] == [1, 1, 1, 2, 0]
    tot = profiling.totals()
    assert tot["counters"] == {"serve.edges.kernel": 3}
    outer, inner = tot["spans"]["serve.outer"], tot["spans"]["serve.inner"]
    assert outer["count"] == 2 and inner["count"] == 1
    r0, r1, r3 = recs[0], recs[1], recs[3]
    want_self = ((r0["end_ns"] - r0["start_ns"]) - (r1["end_ns"] - r1["start_ns"])
                 + (r3["end_ns"] - r3["start_ns"])) * 1e-9
    assert outer["self_s"] == pytest.approx(want_self, abs=1e-12)
    assert inner["self_s"] == pytest.approx(inner["s"], abs=1e-12) and inner["s"] >= 0.01
    assert outer["s"] >= outer["self_s"] + inner["s"] - 1e-9 and outer["self_s"] >= 0.02
    annotated = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert {"serve.outer", "serve.inner", "serve.second", "serve.loose"} <= annotated
    # Recording stopped with the session; the records stay until reset.
    with profiling.span("serve.after"):
        profiling.count("serve.edges.kernel", 5)
    assert profiling.totals() == tot
    profiling.reset()
    assert profiling.totals() == dict(spans={}, counters={})


def test_bench_prefix_is_refused():
    """Every span the program opens is named by a literal outside the
    harness's ``bench.`` prefix, so the harness's spans and the program's
    never mix."""
    root = pathlib.Path(profiling.__file__).resolve().parents[1]
    names, opened = [], 0
    for path in root.rglob("*.py"):
        src = path.read_text()
        opened += len(re.findall(r"profiling\.(?:span|spanned)\(", src))
        names += re.findall(r"profiling\.(?:span|spanned)\(\s*\"([^\"]+)\"\s*\)", src)
    assert opened == len(names) >= 12  # every name a literal
    assert {"serve.setup", "serve.dispatch", "kernel.per_question_topk", "train.optimizer"} <= set(names)
    assert not [n for n in names if n.startswith("bench.")]


def test_serve_split_counts_routes_by_the_grouping_rule(small_ds, bundle):
    samples = small_ds.samples
    order = sorted(range(len(samples)), key=lambda i: samples[i].edge_index.shape[1])
    want = {r: dict(groups=0, edges=0, slots=0) for r in ("kernel", "plain")}  # groups: both routes taken
    for g0 in range(0, len(order), GROUP):
        group = [samples[i] for i in order[g0:g0 + GROUP]]
        m_pad = serving.bucket_width(group, K)
        w = want["kernel" if m_pad >= THRESHOLD else "plain"]
        w["groups"] += 1
        w["edges"] += sum(s.edge_index.shape[1] for s in group)
        w["slots"] += GROUP * m_pad
    assert want["kernel"]["groups"] and want["plain"]["groups"]  # both routes taken
    assert want["kernel"]["edges"] + want["plain"]["edges"] == sum(s.edge_index.shape[1] for s in samples)

    plain_res, plain_stats = _serve(bundle, small_ds)
    with _cpu_profile():
        res, stats = _serve(bundle, small_ds)
    tot = profiling.totals()
    c = tot["counters"]
    for route, w in want.items():
        assert (c[f"serve.edges.{route}"], c[f"serve.slots.{route}"]) == (w["edges"], w["slots"]), route
    assert set(c) == {f"serve.{n}.{r}" for n in ("edges", "slots") for r in ("kernel", "plain")}
    spans = tot["spans"]
    for name in ("serve.setup", "serve.plan", "serve.pack", "serve.dispatch", "serve.stage", "serve.drain"):
        assert spans[name]["count"] >= 1, name
    assert spans["serve.pack"]["count"] == spans["serve.stage"]["count"] == spans["serve.drain"]["count"] \
        == stats.num_windows
    assert "serve.warmup" not in spans and "serve.wait" not in spans  # the CPU neither warms up nor waits
    assert {r["call"] for r in profiling.REGISTRY.spans} == {1}

    # Traced or not, the same answers and the same stats but for the clocks.
    assert [r.sample_id for r in res] == [r.sample_id for r in plain_res]
    for a, b in zip(res, plain_res):
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    clocks = {"index_build_s", "scoring_s", "queries_per_s", "pack_s", "dispatch_s", "drain_s", "compile_s"}
    fields = [f.name for f in dataclasses.fields(serving.ServeStats)]
    for name in set(fields) - clocks:
        assert getattr(stats, name) == getattr(plain_stats, name), name


def test_serve_split_f32_counts_every_group_plain(small_ds, bundle):
    samples = small_ds.samples
    order = sorted(range(len(samples)), key=lambda i: samples[i].edge_index.shape[1])
    slots = sum(GROUP * serving.bucket_width([samples[i] for i in order[g0:g0 + GROUP]], K)
                for g0 in range(0, len(order), GROUP))
    with _cpu_profile():
        _serve(bundle, small_ds, dtype=torch.float32)
    c = profiling.totals()["counters"]
    assert c == {"serve.edges.plain": sum(s.edge_index.shape[1] for s in samples), "serve.slots.plain": slots}


def _train_setup():
    ds = make_synthetic_dataset(num_samples=4, emb_dim=DIM, max_nodes=24, seed=3)
    batch = collate_stacked(ds.samples, num_shards=1, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                            question_emb=ds.question_emb, bucket=fixed_bucket_for(ds.samples, 4))
    cfg = RetrieverTrainConfig(optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3))
    model = Retriever(emb_dim=DIM, hidden_dim=DIM, dropout_p=0.1)
    state, tx = create_train_state(model, None, cfg, seed=2, device="cpu")
    return make_train_step(model, tx, cfg), state, batch


def test_train_step_spans_leave_the_step_bit_for_bit():
    step, state, batch = _train_setup()
    want_state, want = step(state, batch)
    step, state, batch = _train_setup()
    with _cpu_profile():
        got_state, got = step(state, batch)
    spans = profiling.totals()["spans"]
    assert {n: s["count"] for n, s in spans.items()} == {
        "train.upload": 1, "train.forward_backward": 1, "train.optimizer": 1}
    assert {r["call"] for r in profiling.REGISTRY.spans} == {1}
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["grad_norm"], want["grad_norm"])
    a, b = flatten_tree(got_state.params), flatten_tree(want_state.params)
    assert a.keys() == b.keys() and all(torch.equal(a[p], b[p]) for p in a)
    for p, v in want_state.opt_state.items():
        assert torch.equal(got_state.opt_state[p], v) if torch.is_tensor(v) else got_state.opt_state[p] == v, p


def test_trace_writes_spans_json(tmp_path):
    @profiling.one_call
    def body():
        with profiling.span("serve.setup"):
            profiling.count("serve.edges.plain", 7)

    profiling.count("serve.edges.plain")  # off: not counted
    with profiling.trace(tmp_path):
        body()
    assert (tmp_path / "trace.json").exists()
    rec = json.loads((tmp_path / "spans.json").read_text())
    assert rec["counters"] == {"serve.edges.plain": 7}
    (s,) = rec["spans"]
    assert s["name"] == "serve.setup" and s["parent"] == -1 and s["call"] == 1 and s["end_ns"] >= s["start_ns"] > 0
