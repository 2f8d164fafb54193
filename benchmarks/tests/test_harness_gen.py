"""The input generator: one seed, one input; each preset's edge range and
hop mix kept; the one-hop mix yields only m_pad 128 buckets."""

import numpy as np
import pytest
import torch

from benchmarks import gen, harness
from benchmarks.drivers.serve import engine_options

SEED = 3_000_000_017  # past 32 signed bits: a run takes seeds that large


def _graph(name):
    return harness.config(name)["graph"]


@pytest.mark.parametrize("name", ["webqsp", "cwq"])
def test_split_is_deterministic_per_seed(name):
    g = _graph(name)
    a, b = gen.split(SEED, 40, g), gen.split(SEED, 40, g)
    c = gen.split(SEED + 1, 40, g)
    for x, y in zip(a, b):
        for key in ("edge_index", "relations", "entities", "topics", "answers", "labels"):
            np.testing.assert_array_equal(x[key], y[key])
    assert any(not np.array_equal(x["edge_index"], z["edge_index"]) for x, z in zip(a, c))


@pytest.mark.parametrize("name", ["webqsp", "cwq"])
def test_edge_counts_keep_the_clip_and_are_the_same_multiset_for_every_seed(name):
    g = _graph(name)
    sizes = lambda s: sorted(q["edge_index"].shape[1] for q in gen.split(s, 300, g))  # noqa: E731
    assert sizes(SEED) == sizes(7)
    e = np.array(sizes(SEED))
    assert e.min() >= g["edge_min"] and e.max() <= g["edge_max"]
    assert e.max() == g["edge_max"]  # the clip is reached: the tail piles up at the cap
    lognorm = np.exp(g["lognorm_mean"])
    assert 0.8 * lognorm < np.median(e) < 1.25 * lognorm


@pytest.mark.parametrize("name", ["webqsp", "cwq"])
def test_hop_mix_and_planted_chains(name):
    g = _graph(name)
    qs = gen.split(SEED, 400, g)
    hops = np.bincount([q["hops"] for q in qs], minlength=4)[1:] / len(qs)
    np.testing.assert_allclose(hops, np.asarray(g["hop_mix"]) / sum(g["hop_mix"]), atol=1.5 / len(qs))
    for q in qs[:50]:
        ei, r = q["edge_index"], q["relations"]
        n = len(q["entities"])
        assert ei.min() >= 0 and ei.max() < n and (ei[0] != ei[1]).all()
        keys = (ei[0].astype(np.int64) * g["relations"] + r) * n + ei[1]
        assert np.unique(keys).size == keys.size
        assert q["labels"].sum() == q["hops"] * len(q["answers"])
        assert n == max(16, int(ei.shape[1] ** 0.78))
        if q["hops"] >= 2:  # answers only at chain ends
            pos = q["labels"] > 0
            touches = np.isin(ei, q["answers"]).any(axis=0)
            assert not (touches & ~pos).any()


def test_the_one_hop_mix_yields_only_m_pad_128_buckets():
    """``serve_short_256``, kept for the one-hop serve cell (PERF.md §7)."""
    from evi_rag_tpu_torch.serving import bucket_width

    c = dict(config=harness.config("webqsp"), traffic=harness.traffic("serve_short_256"))
    tr, g = c["traffic"], c["config"]["graph"]
    qs = gen.split(SEED, int(c["config"]["splits"][tr["split"]]), g, edge_min=tr["edge_min"],
                   edge_max=tr["edge_max"], rule=tr["edge_rule"])
    from benchmarks.drivers.common import samples

    ss = samples(qs, gen.nontext_flags(SEED, g), "t")
    k, size = c["config"]["model"]["k"], engine_options()["group_size"]
    widths = {bucket_width(ss[i:i + size], k) for i in range(0, len(ss), size)}
    assert widths == {128}


def test_serve_cell_routes_nearly_every_question_to_kernel_3():
    from evi_rag_tpu_torch.serving import bucket_width

    c = harness.cell(harness.load_spec(), "webqsp.serve")
    tr, g = c["traffic"], c["config"]["graph"]
    qs = gen.split(SEED, int(c["config"]["splits"][tr["split"]]), g)
    from benchmarks.drivers.common import samples

    ss = sorted(samples(qs, gen.nontext_flags(SEED, g), "t"), key=lambda s: s.edge_index.shape[1])
    k, opts = c["config"]["model"]["k"], engine_options()
    widths = [bucket_width(ss[i:i + opts["group_size"]], k) for i in range(0, len(ss), opts["group_size"])]
    assert sum(w >= opts["fused_threshold"] for w in widths) >= len(widths) - 1


def test_tables_and_weights_are_deterministic_per_seed():
    g = dict(_graph("webqsp"), entities=50, relations=7)
    a = gen.tables(SEED, g, 64, 9, "cpu")
    b = gen.tables(SEED, g, 64, 9, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert torch.allclose(x.norm(dim=1), torch.ones(x.shape[0]), atol=1e-5)
    w1, w2 = gen.weights(SEED, 64, 32, 20, "cpu"), gen.weights(SEED, 64, 32, 20, "cpu")
    assert w1["state_net_0"]["kernel"].shape == (193, 32)
    assert torch.equal(w1["state_net_0"]["kernel"], w2["state_net_0"]["kernel"])
