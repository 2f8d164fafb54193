"""The kernel route's shape limits: ``kernel_supports``, the serve router
that consults it, and the pooled wrappers' query chunks.

* ``kernel_supports`` at each limit and one step past it; the wrappers'
  own checks keep raising with their messages.
* ``serve_split`` at emb_dim 96, S = 36 (4 + 4 DDE rounds) and k = 1500
  never hands the kernel function a shape it cannot take: those buckets
  take the plain bf16 scorer, the output is exactly the plain serve's
  (every bucket on the plain scorer), the call logs one line naming the
  limit, and the served rankings agree with the JAX engine's (which serves
  any shape) by ``tests/test_serving_parity.py``'s set-overlap rule.
* The pooled wrappers split B into launches of at most ``MAX_QUERIES``
  queries; on the CPU their plain versions over the split batch equal one
  pass over the whole batch.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_bundle
from evi_rag_tpu import serving as jserve
from evi_rag_tpu_torch import serving as tserve
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.ops.query import TripleIndex
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

S = 2 * 2 * (1 + 2 + 2)
F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,h,s,k,limit", [
    (1024, 1024, 32, 1024, None),
    (64, 8, 2, 1, None),
    (1088, 1024, 20, 100, "D=1088: kernel needs D <= 1024"),
    (96, 1024, 20, 100, "D=96: kernel needs D % 64 == 0"),
    (1536, 1024, 20, 100, "D=1536: kernel needs D <= 1024"),
    (1024, 1032, 20, 100, "H=1032: kernel needs H <= 1024"),
    (1024, 2048, 20, 100, "H=2048: kernel needs H <= 1024"),
    (1024, 1020, 20, 100, "H=1020: kernel needs H % 8 == 0"),
    (1024, 1024, 34, 100, "S=34: kernel needs S <= 32"),
    (1024, 1024, 36, 100, "S=36: kernel needs S <= 32"),
    (1024, 1024, 21, 100, "S=21: kernel needs S % 2 == 0"),
    (1024, 1024, 32, 1025, "k=1025: kernel needs 1 <= k <= 1024"),
    (1024, 1024, 20, 1500, "k=1500: kernel needs 1 <= k <= 1024"),
    (96, 2048, 36, 1500, "D=96: kernel needs D % 64 == 0"),
])
def test_kernel_supports_at_each_limit(d, h, s, k, limit):
    assert sk.kernel_limit(d, h, s, k) == limit
    assert sk.kernel_supports(d, h, s, k) is (limit is None)


def _feats(d, h, s, seed=0):
    return bundle_from_numpy(make_bundle(d, h, s, seed=seed)["features"], device="cpu")


@pytest.mark.parametrize("d,h,s,message", [
    (96, 64, S, "kernel needs D % 64 == 0 and D <= 1024, got D=96"),
    (1088, 64, S, "kernel needs D % 64 == 0 and D <= 1024, got D=1088"),
    (64, 1032, S, "kernel needs H % 8 == 0 and H <= 1024, got H=1032"),
    (64, 64, 36, "kernel needs an even struct width <= 32, got S=36"),
])
def test_wrapper_checks_still_raise(d, h, s, message):
    """What ``kernel_supports`` refuses, a wrapper's launch refuses too, with
    the messages it had."""
    bundle = {"features": _feats(d, h, s)}
    with pytest.raises(ValueError, match=message):
        sk._kernel_weights(bundle, None, d, s, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"1 <= k <= min\(M=2048, 1024\), got k=1500"):
        sk._check_k(1500, 2048)
    sk._check_k(1024, 2048)


# (emb_dim, dde rounds each way, k): the shapes that the H100 kernels refuse
# and the Pallas kernels serve; and one that both take.
ROUTES = {
    "emb96": (96, 2, 10, "D=96: kernel needs D % 64 == 0"),
    "s36": (64, 4, 10, "S=36: kernel needs S <= 32"),
    "k1500": (64, 2, 1500, "k=1500: kernel needs 1 <= k <= 1024"),
    "supported": (64, 2, 10, None),
}


def _route_case(name, seed=3):
    emb, rounds, k, _ = ROUTES[name]
    ds = make_synthetic_dataset(num_samples=8, emb_dim=emb, min_nodes=10, max_nodes=40, seed=11)
    np_bundle = make_bundle(emb, emb, 4 * (1 + 2 * rounds), seed=seed)
    rng = np.random.default_rng(seed)
    for key in ("q_gate", "q_bias", "struct_proj", "state_net_0", "state_net_1", "score_head"):
        b = np_bundle["features"][key]["bias"]
        b[:] = 0.1 * rng.normal(size=b.shape)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, k=k,
              num_rounds=rounds, num_reverse_rounds=rounds, group_size=4)
    return ds, np_bundle, kw


@pytest.mark.parametrize("name", list(ROUTES))
def test_serve_routes_unsupported_shapes_to_the_plain_scorer(name, caplog):
    ds, np_bundle, kw = _route_case(name)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    calls = []

    def guarded(bundle, q, h, r, t, s, lengths, *, k, weights):
        if not sk.kernel_supports(h.shape[-1], weights["w1_dist"].shape[-1], s.shape[-1], k):
            raise AssertionError(f"the kernel function got a shape it cannot take (k={k})")
        calls.append(tuple(h.shape))
        return sk.per_question_topk_reference(bundle, q, h, r, t, s, lengths, k=k, weights=weights)

    with caplog.at_level(logging.WARNING, logger="evi_rag_tpu_torch.serving"):
        routed, _ = tserve.serve_split(tb, ds.samples, fused_threshold=8, fused_fn=guarded, device="cpu", **kw)
    lines = [r.getMessage() for r in caplog.records if "kernel needs" in r.getMessage()]
    limit = ROUTES[name][3]
    if limit is None:
        assert calls and not lines
        return
    assert not calls
    assert len(lines) == 1 and limit in lines[0], lines
    plain, _ = tserve.serve_split(tb, ds.samples, fused_threshold=1 << 30, device="cpu", **kw)
    for a, b in zip(routed, plain):
        assert a.sample_id == b.sample_id
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert all(r.edge_ids.size == min(kw["k"], s.edge_index.shape[1]) for r, s in zip(routed, ds.samples))


@pytest.mark.parametrize("name", ["emb96", "s36"])
def test_routed_serve_agrees_with_the_jax_kernel_route(name):
    """JAX serves these shapes through its Pallas route (interpret mode on
    the CPU); the port's plain bf16 scorer gives the same rankings by the
    set-overlap rule against the Pallas route (all but two ids, 0.02 + 2%)."""
    ds, np_bundle, kw = _route_case(name)
    jb = {"features": {k: v for k, v in np_bundle["features"].items()}}
    jres, _ = jserve.serve_split(jb, ds.samples, dtype=jnp.bfloat16, fused_threshold=8, **kw)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    tres, _ = tserve.serve_split(tb, ds.samples, fused_threshold=8, device="cpu", **kw)
    by_id = {r.sample_id: r for r in tres}
    for r in jres:
        ref = dict(zip(r.edge_ids.tolist(), r.scores.tolist()))
        mine = dict(zip(by_id[r.sample_id].edge_ids.tolist(), by_id[r.sample_id].scores.tolist()))
        assert len(ref) == len(mine)
        common = set(ref) & set(mine)
        assert len(common) >= len(ref) - 2, (r.sample_id, set(ref) ^ set(mine))
        for e in common:
            assert abs(ref[e] - mine[e]) < 0.02 + 0.02 * abs(ref[e]), (r.sample_id, e)


@pytest.mark.parametrize("b,plan", [
    (1, [(0, 1)]),
    (65535, [(0, 65535)]),
    (65536, [(0, 65535), (65535, 65536)]),
    (131071, [(0, 65535), (65535, 131070), (131070, 131071)]),
])
def test_query_chunk_plan(b, plan):
    assert sk.query_chunks(b) == plan
    assert all(b1 - b0 <= sk.MAX_QUERIES for b0, b1 in plan)


def _pooled(b=13, m=40, d=64, h=64, seed=2):
    gen = torch.Generator().manual_seed(seed)
    bundle = {"features": _feats(d, h, S, seed=seed)}
    rows = lambda: torch.tanh(torch.randn(m, d, generator=gen)).to(torch.bfloat16)
    index = TripleIndex(head_repr=rows(), rel_repr=rows(), tail_repr=rows(),
                        struct_raw=torch.rand(m, S, generator=gen).to(torch.bfloat16))
    return bundle, torch.randn(b, d, generator=gen), index


def test_pooled_wrappers_join_query_chunks(monkeypatch):
    """With launches cut to 5 queries, 13 queries run as 3 chunks; the joined
    outputs equal the plain versions over all 13 queries at once (ids
    exactly; scores within f32 rounding, as a matmul over 5 rows may sum in
    another order than one over 13), and the CPU counts no launch."""
    bundle, q, index = _pooled()
    rows = (index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    w = sk.prep_weights(bundle["features"])
    whole_scores = sk.score_bidirectional_reference(bundle, q, *rows, weights=w)
    whole_fused = sk.query_topk_fused_reference(bundle, q, index, k=7, weights=w)
    monkeypatch.setattr(sk, "MAX_QUERIES", 5)
    assert sk.query_chunks(13) == [(0, 5), (5, 10), (10, 13)]
    before = (sk.score_bidirectional.launches, sk.query_topk_fused.launches)
    torch.testing.assert_close(sk.score_bidirectional(bundle, q, *rows, weights=w), whole_scores, **F32)
    v, i = sk.query_topk_per_query(bundle, q, index, k=7, weights=w)
    ref_v, ref_i = sk.topk_desc(whole_scores, 7)
    torch.testing.assert_close(v, ref_v, **F32)
    assert torch.equal(i, ref_i)
    v, i = sk.query_topk_fused(bundle, q, index, k=7, weights=w)
    torch.testing.assert_close(v, whole_fused[0], **F32)
    assert torch.equal(i, whole_fused[1])
    assert (sk.score_bidirectional.launches, sk.query_topk_fused.launches) == before
