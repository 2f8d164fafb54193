"""Port vs JAX: the split-serving engine (``serving.py``) end to end.

Both engines serve the same ``make_synthetic_dataset`` split with the same
weights.  f32: identical rankings and scores to rtol 1e-4 / atol 1e-5.
bf16: the set-overlap rule (``tests/test_serving_parity.py``): all but one id
shared, shared scores within 0.01 + 1%; against the Pallas route (tanh GELU,
other rounding) all but two ids and 0.02 + 2%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_bundle
from evi_rag_tpu import serving as jserve
from evi_rag_tpu.data.synthetic import make_synthetic_dataset as j_make
from evi_rag_tpu_torch import serving as tserve
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset as t_make
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

EMB = 64
S = 2 * 2 * (1 + 2 + 2)


def _bundles(seed):
    np_bundle = make_bundle(EMB, EMB, S, seed=seed)
    rng = np.random.default_rng(seed)
    for name in ("q_gate", "q_bias", "struct_proj", "state_net_0", "state_net_1", "score_head"):
        b = np_bundle["features"][name]["bias"]
        b[:] = 0.1 * rng.normal(size=b.shape)
    np_bundle["features"]["non_text_entity_emb"][:] = rng.normal(size=EMB)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    return jax.tree.map(jnp.asarray, np_bundle), tb


def _serve_both(ds, jdtype, tdtype, k=10, group_size=4, seed=3, **kw):
    jb, tb = _bundles(seed)
    common = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                  question_emb=ds.question_emb, k=k, num_rounds=2, num_reverse_rounds=2,
                  group_size=group_size)
    jres, jstats = jserve.serve_split(jb, ds.samples, dtype=jdtype, **common, **kw)
    tres, tstats = tserve.serve_split(tb, ds.samples, dtype=tdtype, device="cpu", **common, **kw)
    return jres, jstats, tres, tstats


def _overlap(jres, tres, *, slack, tol):
    by_id = {r.sample_id: r for r in tres}
    for r in jres:
        got = by_id[r.sample_id]
        ref = dict(zip(r.edge_ids.tolist(), r.scores.tolist()))
        mine = dict(zip(got.edge_ids.tolist(), got.scores.tolist()))
        assert len(ref) == len(mine), r.sample_id
        common = set(ref) & set(mine)
        assert len(common) >= len(ref) - slack, (r.sample_id, set(ref) ^ set(mine))
        for e in common:
            assert abs(ref[e] - mine[e]) < tol + tol * abs(ref[e]), (r.sample_id, e)


@pytest.fixture(scope="module")
def small_ds():
    return j_make(num_samples=10, emb_dim=EMB, max_nodes=30, seed=7)


def test_synthetic_copy_is_identical():
    a = j_make(num_samples=5, emb_dim=16, max_nodes=20, seed=4)
    b = t_make(num_samples=5, emb_dim=16, max_nodes=20, seed=4)
    for name in ("entity_emb", "relation_emb", "question_emb"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for sa, sb in zip(a.samples, b.samples):
        for f in dataclasses.fields(sa):
            va, vb = getattr(sa, f.name), getattr(sb, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb


def test_serve_split_f32_matches_jax(small_ds):
    jres, jstats, tres, tstats = _serve_both(small_ds, jnp.float32, torch.float32)
    assert tstats.num_questions == jstats.num_questions == len(small_ds.samples)
    assert [r.sample_id for r in tres] == [r.sample_id for r in jres]
    for rj, rt in zip(jres, tres):
        np.testing.assert_array_equal(rt.edge_ids, rj.edge_ids)
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-4, atol=1e-5)
    k_grid = [1, 5, 10]
    assert tserve.serve_recall_at_k(small_ds.samples, tres, k_grid) == \
        jserve.serve_recall_at_k(small_ds.samples, jres, k_grid)


def test_serve_split_bf16_matches_jax(small_ds):
    jres, _, tres, _ = _serve_both(small_ds, jnp.bfloat16, torch.bfloat16)
    _overlap(jres, tres, slack=1, tol=0.01)


def test_bf16_scores_come_back_rounded_to_bf16(small_ds):
    """Under bf16 compute every served score is its own bf16 rounding, as
    the JAX engine ships them; f32 requests keep exact f32 scores."""
    _, tb = _bundles(3)
    kw = dict(entity_emb=small_ds.entity_emb, relation_emb=small_ds.relation_emb,
              question_emb=small_ds.question_emb, k=10, num_rounds=2, num_reverse_rounds=2,
              group_size=4, device="cpu")
    rounded = lambda x: torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    bf, _ = tserve.serve_split(tb, small_ds.samples, dtype=torch.bfloat16, **kw)
    for r in bf:
        assert r.scores.dtype == np.float32
        np.testing.assert_array_equal(r.scores, rounded(r.scores))
    f32, _ = tserve.serve_split(tb, small_ds.samples, dtype=torch.float32, **kw)
    all_f32 = np.concatenate([r.scores for r in f32])
    assert (all_f32 != rounded(all_f32)).mean() > 0.9


def test_serve_split_kernel_route_matches_jax_pallas_route():
    """Buckets of 256+ edges take the kernel route in both engines (Pallas
    in interpret mode; the port's plain version on the CPU)."""
    ds = j_make(num_samples=6, emb_dim=EMB, min_nodes=70, max_nodes=90, seed=9)
    jres, _, tres, _ = _serve_both(ds, jnp.bfloat16, torch.bfloat16, k=16, group_size=3)
    assert min(r.edge_ids.size for r in tres) == 16
    _overlap(jres, tres, slack=2, tol=0.02)


def test_float32_never_routes_to_bf16_kernel(small_ds):
    """An f32 request keeps the plain scorer even above the threshold: the
    results are bit-identical to the default routing."""
    _, tb = _bundles(3)
    kw = dict(entity_emb=small_ds.entity_emb, relation_emb=small_ds.relation_emb,
              question_emb=small_ds.question_emb, k=10, num_rounds=2, num_reverse_rounds=2,
              group_size=3, dtype=torch.float32, device="cpu")
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("f32 reached the kernel route")

    plain, _ = tserve.serve_split(tb, small_ds.samples, **kw)
    forced, _ = tserve.serve_split(tb, small_ds.samples, fused_threshold=1, fused_fn=spy, **kw)
    assert not calls
    for a, b in zip(plain, forced):
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_bf16_threshold_routes_to_kernel_function(small_ds):
    _, tb = _bundles(3)
    seen = []

    def spy(bundle, q, h, r, t, s, lengths, *, k, weights):
        seen.append((h.dtype, s.dtype, lengths.dtype, tuple(h.shape)))
        from evi_rag_tpu_torch.ops.score_kernels import per_question_topk_reference
        return per_question_topk_reference(bundle, q, h, r, t, s, lengths, k=k, weights=weights)

    tserve.serve_split(tb, small_ds.samples, entity_emb=small_ds.entity_emb,
                       relation_emb=small_ds.relation_emb, question_emb=small_ds.question_emb,
                       k=10, num_rounds=2, num_reverse_rounds=2, group_size=4,
                       fused_threshold=1, fused_fn=spy, device="cpu")
    assert seen and all(x[:3] == (torch.bfloat16, torch.bfloat16, torch.int32) for x in seen)


def test_serve_stats_fields_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(tserve.ServeStats) == names(jserve.ServeStats)
    assert names(tserve.ServeResult) == names(jserve.ServeResult)


def test_multi_bucket_drain_routing():
    """Several bucket shapes per window, several groups per bucket and a
    trailing partial group: results route back to the right questions."""
    dss = [t_make(num_samples=5, emb_dim=EMB, min_nodes=lo, max_nodes=hi, seed=31 + lo)
           for lo, hi in ((8, 10), (24, 30), (60, 80))]
    samples = []
    for ds in dss:
        for s in ds.samples:
            samples.append(dataclasses.replace(s, question_id=len(samples), sample_id=f"s{len(samples)}"))
    q_emb = np.random.default_rng(0).normal(size=(len(samples), EMB)).astype(np.float32)
    _, tb = _bundles(5)
    kw = dict(entity_emb=dss[0].entity_emb, relation_emb=dss[0].relation_emb, question_emb=q_emb,
              k=8, num_rounds=2, num_reverse_rounds=2, dtype=torch.float32, device="cpu")
    multi, stats = tserve.serve_split(tb, samples, group_size=2, **kw)
    solo, _ = tserve.serve_split(tb, samples, group_size=1, **kw)
    assert stats.num_groups == 8 and len(multi) == len(solo) == len(samples)
    by_id = {r.sample_id: r for r in solo}
    for r in multi:
        np.testing.assert_array_equal(r.edge_ids, by_id[r.sample_id].edge_ids)
        np.testing.assert_allclose(r.scores, by_id[r.sample_id].scores, rtol=1e-5, atol=1e-6)


def test_dispatch_ladder_and_window_budget(small_ds, monkeypatch):
    """The B ladder and small byte-budgeted windows give the same results as
    one flat dispatch; warmup changes nothing."""
    _, tb = _bundles(3)
    kw = dict(entity_emb=small_ds.entity_emb, relation_emb=small_ds.relation_emb,
              question_emb=small_ds.question_emb, k=10, num_rounds=2, num_reverse_rounds=2,
              group_size=1, dtype=torch.float32, device="cpu")
    flat, _ = tserve.serve_split(tb, small_ds.samples, **kw)
    monkeypatch.setenv("EVI_SERVE_B_WINDOW", "2")
    monkeypatch.setenv("EVI_SERVE_B_WINDOW_MAX", "4")
    monkeypatch.setenv("EVI_SERVE_WINDOW_BYTES", "4096")
    ladder, stats = tserve.serve_split(tb, small_ds.samples, warmup=True, **kw)
    assert stats.num_windows > 1 and stats.compile_s > 0
    for a, b in zip(flat, ladder):
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_mesh_serving_not_ported(small_ds):
    """Data-parallel serving is ported: over a mesh of two CPU entries every
    question comes back with the single-device serve's ids and scores
    (``tests/test_torch_dp_serve.py`` holds it to JAX's)."""
    from evi_rag_tpu_torch.parallel.mesh import make_mesh

    _, tb = _bundles(3)
    kw = dict(entity_emb=small_ds.entity_emb, relation_emb=small_ds.relation_emb,
              question_emb=small_ds.question_emb, k=10, num_rounds=2, num_reverse_rounds=2, group_size=4)
    single, _ = tserve.serve_split(tb, small_ds.samples, device="cpu", **kw)
    dp, stats = tserve.serve_split(tb, small_ds.samples, mesh=make_mesh(devices=["cpu"] * 2), **kw)
    assert stats.num_questions == len(small_ds.samples)
    for a, b in zip(single, dp):
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
