"""Port vs JAX: kNN over an embedding table (``ops/knn.py``).

The inputs of ``tests/test_knn.py`` (B = 4, V = 1000, D = 64, k = 10, seed 0)
through both packages at f32.  The chunked scan is forced as the JAX test
forces it (``_ONESHOT_BYTES = 0``, chunk 256).

* ``knn_topk`` for dot / cosine / l2, one-shot and chunked: equal id sets,
  values within rtol 1e-4 / atol 1e-4 of JAX's (``tests/test_knn.py``'s
  bar; l2 values agree as well, both drop the same ``||q||^2``).
* ``method="approx"`` (the port's PartialReduce): an overlap of at least
  0.8 k with the exact top-k, one-shot and chunked (``tests/test_knn.py``'s
  bar), and the bin count meets its recall target.
* ``knn_topk_sharded`` over 8 shards against JAX's over ``make_mesh(8)``:
  values within 1e-5, equal id sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import evi_rag_tpu.ops.knn as jknn
import evi_rag_tpu_torch.ops.knn as tknn
from evi_rag_tpu.parallel.mesh import make_mesh as j_make_mesh
from evi_rag_tpu_torch.ops import knn_topk, knn_topk_sharded
from evi_rag_tpu_torch.parallel.mesh import make_mesh

B, V, D, K = 4, 1000, 64, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(B, D)).astype(np.float32), rng.normal(size=(V, D)).astype(np.float32)


def _run(q, t, monkeypatch, path, **kw):
    if path == "chunked":
        monkeypatch.setattr(jknn, "_ONESHOT_BYTES", 0)
        monkeypatch.setattr(tknn, "_ONESHOT_BYTES", 0)
        kw["chunk"] = 256
        jv, ji = jknn.knn_topk.__wrapped__(jnp.asarray(q), jnp.asarray(t), dtype=jnp.float32, **kw)
    else:
        jv, ji = jknn.knn_topk(jnp.asarray(q), jnp.asarray(t), dtype=jnp.float32, **kw)
    tv, ti = knn_topk(torch.as_tensor(q), torch.as_tensor(t), dtype=torch.float32, **kw)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("path", ["oneshot", "chunked"])
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
def test_knn_matches_jax(data, monkeypatch, metric, path):
    jv, ji, tv, ti = _run(*data, monkeypatch, path, k=K, metric=metric)
    assert ti.dtype == np.int32 and ti.shape == (B, K)
    for b in range(B):
        assert set(ti[b].tolist()) == set(ji[b].tolist())
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
    assert (np.diff(tv, axis=1) <= 0).all()


@pytest.mark.parametrize("path", ["oneshot", "chunked"])
def test_knn_approx_overlaps_exact(data, monkeypatch, path):
    q, t = data
    _, exact = knn_topk(torch.as_tensor(q), torch.as_tensor(t), k=K, metric="cosine", dtype=torch.float32)
    if path == "chunked":
        monkeypatch.setattr(tknn, "_ONESHOT_BYTES", 0)
    _, approx = knn_topk(torch.as_tensor(q), torch.as_tensor(t), k=K, chunk=256, metric="cosine",
                         dtype=torch.float32, method="approx")
    for b in range(B):
        assert len(set(exact[b].tolist()) & set(approx[b].tolist())) >= int(0.8 * K)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_partial_reduce_bins_meet_the_recall_target(k):
    bins = tknn.partial_reduce_bins(k)
    expected = lambda n: n / k * (1 - (1 - 1 / n) ** k)  # noqa: E731
    assert bins >= k and expected(bins) >= tknn.RECALL_TARGET
    assert k == 1 or expected(bins - 1) < tknn.RECALL_TARGET or bins == k


def test_partial_reduce_keeps_each_bins_maximum():
    """Column j falls in bin j mod L; the result holds each kept bin's
    maximum with its column id, values descending."""
    s = torch.randn(3, 5000, generator=torch.Generator().manual_seed(1))
    vals, ids = tknn.partial_reduce_topk(s, 10)
    assert torch.equal(torch.gather(s, 1, ids), vals) and (vals[:, 1:] <= vals[:, :-1]).all()
    bins = tknn.partial_reduce_bins(10)
    for b in range(3):
        for j in ids[b].tolist():
            assert s[b, j] == s[b, j % bins::bins].max()


def test_knn_sharded_matches_jax(data):
    q, t = data
    t8 = t[:960]
    jmesh = j_make_mesh(8)
    jv, ji = jknn.knn_topk_sharded(jnp.asarray(q), jax.device_put(jnp.asarray(t8), NamedSharding(jmesh, P("data"))),
                                   mesh=jmesh, k=K, chunk=128, dtype=jnp.float32)
    mesh = make_mesh(devices=["cpu"] * 8)
    tv, ti = knn_topk_sharded(torch.as_tensor(q), torch.as_tensor(t8), mesh=mesh, k=K, chunk=128, dtype=torch.float32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    for b in range(B):
        assert set(ti[b].tolist()) == set(np.asarray(ji[b]).tolist())
    with pytest.raises(ValueError, match="divide evenly"):
        knn_topk_sharded(torch.as_tensor(q), torch.as_tensor(t), mesh=make_mesh(devices=["cpu"] * 3), k=K)
