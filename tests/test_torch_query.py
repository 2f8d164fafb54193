"""Port vs JAX: the plain per-question scorer and top-k (``ops/query.py``).

f32: scores to rtol 1e-4 / atol 1e-5 and identical ids (the serving parity
tolerance of ``tests/test_serving_parity.py``).  bf16: the two frameworks
round at the same points but may keep excess precision differently inside
fusions, so the top-k sets may swap near-ties: all but one id shared, and
scores on the shared ids within 0.01 + 1% (the same set-overlap rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_inputs, make_bundle
from evi_rag_tpu.ops.query import query_topk_per_question as j_topk
from evi_rag_tpu_torch.ops.query import query_topk_per_question as t_topk
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

D, H, S, G, M, K = 64, 64, 20, 3, 96, 12


@pytest.fixture(scope="module")
def case():
    np_bundle = make_bundle(D, H, S, seed=5)
    ins = build_inputs(G * M, D, S, batch=G, seed=5)
    shape = lambda a: a.reshape(G, M, -1)
    lengths = np.array([M, 40, 7])
    mask = np.arange(M)[None, :] < lengths[:, None]
    arrays = dict(q=ins["q"], h=shape(ins["head"]), r=shape(ins["rel"]),
                  t=shape(ins["tail"]), s=shape(ins["struct"]), mask=mask)
    jb = jax.tree.map(jnp.asarray, np_bundle)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    return jb, tb, arrays


def _run(case, dtype, k=K):
    jb, tb, a = case
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    order = ("q", "h", "r", "t", "s", "mask")
    jv, ji = j_topk(jb, *(jnp.asarray(a[n]) for n in order), k=k, dtype=jdt)
    tv, ti = t_topk(tb, *(torch.as_tensor(a[n]) for n in order), k=k, dtype=tdt)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def test_f32_matches_jax_exact_ids(case):
    jv, ji, tv, ti = _run(case, "f32")
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-5)
    # Padding never surfaces as a finite score: question 2 has 7 edges.
    assert np.isfinite(tv[2, :7]).all() and np.isneginf(tv[2, 7:]).all()


def test_bf16_matches_jax_set_overlap(case):
    jv, ji, tv, ti = _run(case, "bf16")
    for g in range(G):
        keep_j, keep_t = np.isfinite(jv[g]), np.isfinite(tv[g])
        ref = dict(zip(ji[g][keep_j].tolist(), jv[g][keep_j].tolist()))
        got = dict(zip(ti[g][keep_t].tolist(), tv[g][keep_t].tolist()))
        common = set(ref) & set(got)
        assert len(common) >= len(ref) - 1, (g, set(ref) ^ set(got))
        for e in common:
            assert abs(ref[e] - got[e]) < 0.01 + 0.01 * abs(ref[e]), (g, e)


def test_k_above_length_pads_neg_inf_in_index_order(case):
    """Unfilled slots are -inf and carry the padding ids in ascending order,
    as ``jax.lax.top_k`` returns them."""
    jv, ji, tv, ti = _run(case, "f32", k=M)
    np.testing.assert_array_equal(ti[2, 7:], np.arange(7, M))
    np.testing.assert_array_equal(ti[2, 7:], ji[2, 7:])
    assert np.isneginf(tv[2, 7:]).all()


def test_equal_scores_come_back_lower_index_first(case):
    """Duplicate candidate rows score identically; the lower index ranks first."""
    _, tb, a = case
    h = a["h"].copy(); r = a["r"].copy(); t = a["t"].copy(); s = a["s"].copy()
    for x in (h, r, t, s):
        x[:, 50] = x[:, 10]
        x[:, 30] = x[:, 10]
    mask = np.ones((G, M), bool)
    vals, ids = t_topk(tb, *(torch.as_tensor(x) for x in (a["q"], h, r, t, s, mask)),
                       k=M, dtype=torch.float32)
    for g in range(G):
        pos = {int(e): i for i, e in enumerate(ids[g].tolist())}
        assert pos[10] < pos[30] < pos[50]
        assert pos[50] - pos[10] == 2  # adjacent: the three tie
        assert vals[g, pos[10]] == vals[g, pos[50]]
