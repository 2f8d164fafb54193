"""Whole runs at a tiny size on the CPU with the timed path broken
underneath: each fault a cell can have makes ``correct`` false under the
cell's committed limits, where the sound run is correct.  One chip: no
exchange between chips to leave out."""

import functools
import json

import numpy as np
import pytest
import torch

from benchmarks.run import run_cell
from benchmarks.tests import tiny

SEED = 2_400_000_007


def _run(workload, seconds=0.3):
    line = run_cell(tiny.cell(workload), workload, SEED, seconds, False, torch.device("cpu"),
                    log=lambda *a, **k: None)
    return json.loads(line)


@pytest.mark.parametrize("workload", ["webqsp.serve", "cwq.pooled", "cwq.train"])
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


def _other_id(ids, n):
    free = np.setdiff1d(np.arange(n), ids)
    return int(free[0]) if free.size else None


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    import evi_rag_tpu_torch.serving as serving

    real = serving.serve_split

    @functools.wraps(real)
    def altered(bundle, samples, **kw):
        res, stats = real(bundle, samples, **kw)
        for r, s in zip(res, samples):
            other = _other_id(r.edge_ids, s.edge_index.shape[1])
            if other is not None:
                r.edge_ids = r.edge_ids.copy()
                r.edge_ids[0] = other
            else:
                r.scores = r.scores.copy()
                r.scores[0] += 0.5
        return res, stats

    monkeypatch.setattr(serving, "serve_split", altered)
    assert not _run("webqsp.serve")["correct"]


def test_half_of_a_request_left_out(monkeypatch):
    import evi_rag_tpu_torch.serving as serving

    real = serving.serve_split

    @functools.wraps(real)
    def half(bundle, samples, **kw):
        res, stats = real(bundle, samples[: len(samples) // 2], **kw)
        return res, stats

    monkeypatch.setattr(serving, "serve_split", half)
    out = _run("webqsp.serve")
    assert not out["correct"] and out["failed"] > 0


def test_a_pooled_answer_altered_where_it_is_produced(monkeypatch):
    import evi_rag_tpu_torch.ops.score_kernels as sk

    real = sk.query_topk_fused

    def altered(*a, **kw):
        v, i = real(*a, **kw)
        m = a[2].num_candidates
        i = i.clone()
        for row in range(i.shape[0]):
            i[row, 0] = _other_id(i[row].numpy(), m)
        return v, i

    monkeypatch.setattr(sk, "query_topk_fused", altered)
    assert not _run("cwq.pooled")["correct"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    import evi_rag_tpu_torch.train.retriever_trainer as rt

    real = rt.make_train_step

    def frozen(*a, **kw):
        step = real(*a, **kw)

        def unchanged(state, batch):
            saved = {k: v.detach().clone() for k, v in rt.flatten_tree(state.params).items()}
            new, metrics = step(state, batch)
            with torch.no_grad():
                for k, v in rt.flatten_tree(new.params).items():
                    v.copy_(saved[k])
            return state, metrics

        return unchanged

    monkeypatch.setattr(rt, "make_train_step", frozen)
    out = _run("cwq.train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    import evi_rag_tpu_torch.train.retriever_trainer as rt

    real = rt.retriever_loss

    def half(logits, labels, edge_batch, *, graph_mask, **kw):
        n = int(graph_mask.sum())
        keep = torch.arange(graph_mask.shape[0], device=graph_mask.device) < n // 2
        return real(logits, labels, edge_batch, graph_mask=graph_mask & keep, **kw)

    monkeypatch.setattr(rt, "retriever_loss", half)
    assert not _run("cwq.train")["correct"]
