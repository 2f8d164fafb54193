"""Port vs JAX: the retriever loss and the eval metrics on identical inputs.

* ``retriever_loss`` (InfoNCE at T = 0.07, with BCE and near / bridge edge
  weights, and a degenerate batch): loss, components, metrics and the
  gradient with respect to the logits at f32 rtol 1e-4 / atol 1e-5, and
  finite.
* Metrics on identical scores (rounded, so that ties occur): in-graph ranks,
  recall@k (plain, bridge subset), margins, component labels, reachability@k
  and the coverage counts are exact; the per-graph mean probabilities are
  sums of floats in another order, so they are held at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.eval import metrics as jmet
from evi_rag_tpu.models.losses import RetrieverLossConfig as JCfg, retriever_loss as jloss
from evi_rag_tpu.train import retriever_trainer as jtrain
from evi_rag_tpu_torch.data.feeder import Bucket
from evi_rag_tpu_torch.eval import metrics as tmet
from evi_rag_tpu_torch.models.losses import RetrieverLossConfig as TCfg, retriever_loss as tloss
from evi_rag_tpu_torch.train import retriever_trainer as ttrain

from _torch_train_common import F32, batches, datasets

KS = (1, 3, 5, 10, 40, 400)


@pytest.fixture(scope="module")
def data():
    jds, tds = datasets(num_samples=6, max_nodes=20)
    jb, tb = batches(jds, tds, 0, 6, Bucket(graphs=8, nodes=160, edges=512))
    scores = np.round(np.random.default_rng(1).normal(size=tb.graph.num_edges), 1).astype(np.float32)
    return jb, tb, scores


def _eq(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def test_ranks_recall_margin_coverage_exact(data):
    jb, tb, s = data
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    for sub in (None, "bridge"):
        jm = None if sub is None else ~jb.edge_is_near
        tm = None if sub is None else ~tb.edge_is_near
        _eq(tmet.edge_ranks_in_graph(ts, tb.graph.edge_batch, tb.graph.edge_ptr, subset_mask=tm),
            jmet.edge_ranks_in_graph(js, jb.graph.edge_batch, jb.graph.edge_ptr, subset_mask=jm), "ranks")
        want = jmet.edge_recall_at_k(js, jb.edge_labels, jb, KS, subset_mask=jm, require_positive=sub is not None)
        got = tmet.edge_recall_at_k(ts, tb.edge_labels, tb, KS, subset_mask=tm, require_positive=sub is not None)
        assert got.keys() == want.keys()
        for k in want:
            _eq(got[k], want[k], k)
    for k, v in jmet.score_margin(js, jb.edge_labels, jb).items():
        _eq(tmet.score_margin(ts, tb.edge_labels, tb)[k], v, k)
    for k, v in jmet.bridge_positive_coverage(jb.edge_labels, jb).items():
        assert float(tmet.bridge_positive_coverage(tb.edge_labels, tb)[k]) == float(v), k
    want = jmet.prob_quality(js, jb.edge_labels, jb, subset_mask=~jb.edge_is_near)
    got = tmet.prob_quality(ts, tb.edge_labels, tb, subset_mask=~tb.edge_is_near)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


def test_components_and_reachability_exact(data):
    jb, tb, s = data
    rng = np.random.default_rng(2)
    sub = rng.random(tb.graph.num_edges) < 0.3
    _eq(tmet.connected_component_labels(tb.graph.edge_index, torch.from_numpy(sub), tb.graph.num_nodes),
        jmet.connected_component_labels(jb.graph.edge_index, jnp.asarray(sub), jb.graph.num_nodes), "labels")
    want = jmet.answer_reachability_at_k(jnp.asarray(s), jb, KS)
    got, sweeps = tmet.answer_reachability_sweeps(torch.from_numpy(s), tb, KS)
    assert sweeps >= 1 and tmet.answer_reachability_at_k(torch.from_numpy(s), tb, KS).keys() == got.keys()
    assert got.keys() == want.keys()
    for k in want:
        _eq(got[k], want[k], k)
    assert any(bool(np.asarray(v).any()) for k, v in want.items() if k.startswith("reach"))
    assert tmet.normalize_k_values([5, 0, 5, 2]) == jmet.normalize_k_values([5, 0, 5, 2]) == (2, 5)


def test_evaluate_results_aggregates_like_jax(data):
    """``evaluate_results`` over per-batch eval outputs: the same keys and
    the same means (host sums in float64)."""
    jb, tb, s = data
    cfg_k = (1, 5, 10)
    want = jtrain.evaluate_results([_eval_terms_jax(jb, s, cfg_k)])
    got = ttrain.evaluate_results([_eval_terms_torch(tb, s, cfg_k)])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def _eval_terms_jax(jb, s, ks):
    js = jnp.asarray(s)
    res = {}
    for prefix, kw in (("edge", {}), ("bridge", dict(subset_mask=~jb.edge_is_near, require_positive=True))):
        r = jmet.edge_recall_at_k(js, jb.edge_labels, jb, ks, **kw)
        res.update({f"{prefix}/{k}": v for k, v in r.items()})
    reach = jmet.answer_reachability_at_k(js, jb, ks)
    res.update({f"answer/{k}": v for k, v in reach.items()})
    sm = jmet.score_margin(js, jb.edge_labels, jb)
    res.update({"edge/score_margin": sm["margin"], "edge/margin_positive_rate": (sm["margin"] > 0) * 1.0,
                "edge/margin_valid": sm["graph_valid"]})
    pq = jmet.prob_quality(js, jb.edge_labels, jb, subset_mask=~jb.edge_is_near)
    res.update({f"bridge/{k}": v for k, v in pq.items() if k != "graph_valid"})
    res["bridge/quality_valid"] = pq["graph_valid"]
    res["coverage"] = jmet.bridge_positive_coverage(jb.edge_labels, jb)
    res.update({"features/pos_prob_avg": 0.7, "features/neg_prob_avg": 0.2, "features/norm_avg": 3.0})
    return res


def _eval_terms_torch(tb, s, ks):
    ts = torch.from_numpy(s)
    res = {}
    for prefix, kw in (("edge", {}), ("bridge", dict(subset_mask=~tb.edge_is_near, require_positive=True))):
        r = tmet.edge_recall_at_k(ts, tb.edge_labels, tb, ks, **kw)
        res.update({f"{prefix}/{k}": v for k, v in r.items()})
    reach = tmet.answer_reachability_at_k(ts, tb, ks)
    res.update({f"answer/{k}": v for k, v in reach.items()})
    sm = tmet.score_margin(ts, tb.edge_labels, tb)
    res.update({"edge/score_margin": sm["margin"], "edge/margin_positive_rate": (sm["margin"] > 0).float(),
                "edge/margin_valid": sm["graph_valid"]})
    pq = tmet.prob_quality(ts, tb.edge_labels, tb, subset_mask=~tb.edge_is_near)
    res.update({f"bridge/{k}": v for k, v in pq.items() if k != "graph_valid"})
    res["bridge/quality_valid"] = pq["graph_valid"]
    res["coverage"] = tmet.bridge_positive_coverage(tb.edge_labels, tb)
    res.update({"features/pos_prob_avg": 0.7, "features/neg_prob_avg": 0.2, "features/norm_avg": 3.0})
    return res


@pytest.mark.parametrize("kw", [
    dict(infonce_temperature=0.07),
    dict(infonce_temperature=0.5, bce_weight=0.5, edge_weight_near=2.0, edge_weight_bridge=0.5),
    dict(infonce_weight=0.0, bce_weight=1.0),
])
@pytest.mark.parametrize("degenerate", [False, True])
def test_retriever_loss_and_logit_gradients_match_jax(data, kw, degenerate):
    jb, tb, s = data
    labels = np.asarray(jb.edge_labels) * (0.0 if degenerate else 1.0)
    near = np.array(jb.edge_is_near)
    args = lambda lib, b: dict(num_graphs=b.graph.num_graphs, graph_mask=b.graph.graph_mask,
                               edge_mask=b.graph.edge_mask)

    def jfn(x):
        out = jloss(x, jnp.asarray(labels), jb.graph.edge_batch, config=JCfg(**kw),
                    edge_is_near=jnp.asarray(near), **args(jnp, jb))
        return out.loss, out

    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_(True)
    tout = tloss(x, torch.from_numpy(labels), tb.graph.edge_batch, config=TCfg(**kw),
                 edge_is_near=torch.from_numpy(near), **args(torch, tb))
    tout.loss.backward()
    np.testing.assert_allclose(tout.loss.item(), float(jout.loss), **F32)
    for k in jout.components:
        np.testing.assert_allclose(tout.components[k].item(), float(jout.components[k]), err_msg=k, **F32)
    for k in jout.metrics:
        np.testing.assert_allclose(tout.metrics[k].item(), float(jout.metrics[k]), err_msg=k, **F32)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **F32)
    if degenerate and kw.get("bce_weight", 0.0) == 0.0:
        assert tout.loss.item() == 0.0
