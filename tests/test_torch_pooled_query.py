"""Port vs JAX: the pooled index-and-query engine.

The same numpy inputs (``bench.py``'s ``make_bundle`` and ``build_inputs``,
weights carried over by ``bundle_from_numpy``) go through both packages at
D = H = 128, S = 20, M = 1000 (not a multiple of any tile), B = 3, k = 20.

* ``build_triple_index``: f32, rtol 1e-5.
* ``score_all`` and ``query_topk`` in f32: identical ids, scores to
  rtol 1e-4 / atol 1e-5 (``tests/test_serving_parity.py``'s f32 tolerance).
* ``query_topk`` in bf16: set overlap, all but one id shared, shared scores
  within 0.01 + 1% (the two frameworks round bf16 at other points).
* The kernels' wrappers on the CPU (their plain versions) against the Pallas
  kernels in interpret mode and the XLA path in bf16: all but two ids
  shared, 0.02 + 2%; the extra room is the tanh-vs-erf GELU gap, as in
  ``tests/test_torch_score_kernels.py``.

The kernels themselves run only on a card: ``tests/test_torch_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_inputs, make_bundle
from evi_rag_tpu.ops import query as jq
from evi_rag_tpu.ops.pallas_score import (
    pallas_query_topk,
    pallas_query_topk_fused,
    pallas_score_bidirectional,
)
from evi_rag_tpu_torch.ops import query as tq
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

D, H, S, M, B, K = 128, 128, 20, 1000, 3, 20
V, R = 300, 17
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def case():
    np_bundle = make_bundle(D, H, S, seed=2)
    rng = np.random.default_rng(2)
    for name in ("q_gate", "q_bias", "struct_proj", "state_net_0", "state_net_1", "score_head"):
        b = np_bundle["features"][name]["bias"]
        b[:] = 0.1 * rng.normal(size=b.shape)
    np_bundle["features"]["non_text_entity_emb"][:] = rng.normal(size=D)
    ins = build_inputs(M, D, S, batch=B, seed=2)
    tables = dict(
        entity_emb=rng.normal(size=(V, D)).astype(np.float32),
        relation_emb=rng.normal(size=(R, D)).astype(np.float32),
        nontext_mask=rng.random(V) < 0.1,
        heads=rng.integers(0, V, M).astype(np.int32),
        rels=rng.integers(0, R, M).astype(np.int32),
        tails=rng.integers(0, V, M).astype(np.int32),
        struct_raw=ins["struct"],
    )
    jb = jax.tree.map(jnp.asarray, np_bundle)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    j_index = jq.build_triple_index(jb, **{n: jnp.asarray(x) for n, x in tables.items()})
    t_index = tq.build_triple_index(tb, **tables, device="cpu")
    return dict(jb=jb, tb=tb, q=ins["q"], tables=tables, j_index=j_index, t_index=t_index)


def _overlap(ref_v, ref_i, got_v, got_i, *, slack, tol):
    for g in range(ref_v.shape[0]):
        ref = {int(e): float(v) for e, v in zip(ref_i[g], ref_v[g]) if np.isfinite(v)}
        got = {int(e): float(v) for e, v in zip(got_i[g], got_v[g]) if np.isfinite(v)}
        assert len(ref) == len(got), g
        common = set(ref) & set(got)
        assert len(common) >= len(ref) - slack, (g, set(ref) ^ set(got))
        for e in common:
            assert abs(ref[e] - got[e]) < tol + tol * abs(ref[e]), (g, e, ref[e], got[e])


def _jax_topk(case, **kw):
    v, i = jq.query_topk(case["jb"], jnp.asarray(case["q"]), case["j_index"], **kw)
    return np.asarray(v), np.asarray(i)


def _bf16_index(case):
    return case["t_index"].to(dtype=torch.bfloat16)


def test_build_triple_index_matches_jax(case):
    j, t = case["j_index"], case["t_index"]
    assert t.num_candidates == M
    for name in ("head_repr", "rel_repr", "tail_repr", "struct_raw"):
        got = getattr(t, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, name)), rtol=1e-5, atol=1e-6)
    # Flagged rows take the projected non-text row.
    flagged = np.nonzero(case["tables"]["nontext_mask"][case["tables"]["heads"]])[0]
    assert flagged.size > 0
    np.testing.assert_array_equal(t.head_repr[flagged].numpy(),
                                  np.broadcast_to(t.head_repr[flagged[0]].numpy(), (flagged.size, D)))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_score_all_f32_matches_jax(case, bidirectional):
    want = jq.score_all(case["jb"], jnp.asarray(case["q"]), case["j_index"], bidirectional=bidirectional)
    got = tq.score_all(case["tb"], torch.as_tensor(case["q"]), case["t_index"], chunk=256,
                       bidirectional=bidirectional, device="cpu")
    assert got.shape == (B, M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_query_topk_f32_matches_jax(case, bidirectional):
    kw = dict(k=K, chunk=256, bidirectional=bidirectional)
    jv, ji = _jax_topk(case, dtype=jnp.float32, **kw)
    tv, ti = tq.query_topk(case["tb"], torch.as_tensor(case["q"]), case["t_index"],
                           dtype=torch.float32, device="cpu", **kw)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, **F32)


def test_query_topk_bf16_matches_jax(case):
    jv, ji = _jax_topk(case, k=K, chunk=256, dtype=jnp.bfloat16)
    tv, ti = tq.query_topk(case["tb"], torch.as_tensor(case["q"]), case["t_index"], k=K, chunk=256,
                           device="cpu")
    _overlap(jv, ji, tv.numpy(), ti.numpy(), slack=1, tol=0.01)


def test_query_topk_k_above_m_pads_like_jax(case):
    """k > M: unfilled slots are -inf with id -1, as in JAX."""
    m = 7
    j_small = jq.TripleIndex(*(x[:m] for x in (case["j_index"].head_repr, case["j_index"].rel_repr,
                                               case["j_index"].tail_repr, case["j_index"].struct_raw)))
    t_small = tq.TripleIndex(*(x[:m] for x in (case["t_index"].head_repr, case["t_index"].rel_repr,
                                               case["t_index"].tail_repr, case["t_index"].struct_raw)))
    jv, ji = jq.query_topk(case["jb"], jnp.asarray(case["q"]), j_small, k=12, chunk=4, dtype=jnp.float32)
    tv, ti = tq.query_topk(case["tb"], torch.as_tensor(case["q"]), t_small, k=12, chunk=4,
                           dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy()[:, m:] == -1).all() and np.isneginf(tv.numpy()[:, m:]).all()
    np.testing.assert_allclose(tv.numpy()[:, :m], np.asarray(jv)[:, :m], **F32)


def test_score_bidirectional_matches_pallas_interpret(case):
    idx = _bf16_index(case)
    got = sk.score_bidirectional(case["tb"], torch.as_tensor(case["q"]), idx.head_repr, idx.rel_repr,
                                 idx.tail_repr, idx.struct_raw).numpy()
    j = case["j_index"]
    assert got.shape == (B, M)
    for b in range(B):
        want = np.asarray(pallas_score_bidirectional(
            case["jb"], jnp.asarray(case["q"][b]), j.head_repr, j.rel_repr, j.tail_repr, j.struct_raw,
            tile=256, interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=0.02, atol=0.02)


def test_query_topk_per_query_matches_pallas_interpret(case):
    jv, ji = pallas_query_topk(case["jb"], jnp.asarray(case["q"]), case["j_index"], k=K, tile=256,
                               interpret=True)
    tv, ti = sk.query_topk_per_query(case["tb"], torch.as_tensor(case["q"]), _bf16_index(case), k=K)
    assert tv.shape == (B, K) and ti.dtype == torch.int32
    _overlap(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(), slack=2, tol=0.02)


def test_query_topk_fused_matches_pallas_fused_interpret(case):
    jv, ji = pallas_query_topk_fused(case["jb"], jnp.asarray(case["q"]), case["j_index"], k=K, bq=2,
                                     tile=256, interpret=True)
    tv, ti = sk.query_topk_fused(case["tb"], torch.as_tensor(case["q"]), _bf16_index(case), k=K)
    assert tv.shape == (B, K) and ti.dtype == torch.int32
    _overlap(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(), slack=2, tol=0.02)


def test_query_topk_fused_matches_xla_bf16(case):
    jv, ji = _jax_topk(case, k=K, dtype=jnp.bfloat16)
    tv, ti = sk.query_topk_fused(case["tb"], torch.as_tensor(case["q"]), _bf16_index(case), k=K)
    _overlap(jv, ji, tv.numpy(), ti.numpy(), slack=2, tol=0.02)


def test_fused_form_agrees_with_twin_form(case):
    """The factorised plain version and the per-edge one compute the same
    function with other bf16 rounding points."""
    idx = _bf16_index(case)
    args = (case["tb"], torch.as_tensor(case["q"]), idx.head_repr, idx.rel_repr, idx.tail_repr,
            idx.struct_raw)
    np.testing.assert_allclose(sk.fused_scores_reference(*args).numpy(),
                               sk.score_bidirectional_reference(*args).numpy(), rtol=0.02, atol=0.02)


@pytest.mark.parametrize("path", ["query_topk", "per_query", "fused"])
def test_query_results_do_not_depend_on_the_batch(case, path):
    idx = _bf16_index(case)
    q = torch.as_tensor(case["q"])
    run = {
        "query_topk": lambda x: tq.query_topk(case["tb"], x, case["t_index"], k=K, device="cpu"),
        "per_query": lambda x: sk.query_topk_per_query(case["tb"], x, idx, k=K),
        "fused": lambda x: sk.query_topk_fused(case["tb"], x, idx, k=K),
    }[path]
    all_v, all_i = run(q)
    for b in range(B):
        v, i = run(q[b : b + 1])
        np.testing.assert_array_equal(i[0].numpy(), all_i[b].numpy())
        np.testing.assert_allclose(v[0].numpy(), all_v[b].numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_count_no_launch(case):
    idx = _bf16_index(case)
    q = torch.as_tensor(case["q"])
    before = (sk.score_bidirectional.launches, sk.query_topk_fused.launches)
    sk.score_bidirectional(case["tb"], q, idx.head_repr, idx.rel_repr, idx.tail_repr, idx.struct_raw)
    sk.query_topk_per_query(case["tb"], q, idx, k=K)
    sk.query_topk_fused(case["tb"], q, idx, k=K)
    assert (sk.score_bidirectional.launches, sk.query_topk_fused.launches) == before


def test_wrappers_reject_other_devices_and_bad_k(case):
    meta = tq.TripleIndex(*(torch.empty(M, n, device="meta") for n in (D, D, D, S)))
    q = torch.empty(B, D, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sk.score_bidirectional(case["tb"], q, meta.head_repr, meta.rel_repr, meta.tail_repr, meta.struct_raw)
    for fn in (sk.query_topk_per_query, sk.query_topk_fused):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(case["tb"], q, meta, k=K)
        for k in (0, M + 1, 1025):
            with pytest.raises(ValueError, match="1 <= k"):
                fn(case["tb"], torch.as_tensor(case["q"]), _bf16_index(case), k=k)
