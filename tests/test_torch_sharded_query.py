"""Port vs JAX: the pooled engine fanned out over a mesh.

The JAX functions run on the 8 virtual CPU devices of ``tests/conftest.py``
(``make_mesh(8)``); the port's on a mesh of ``["cpu"] * 8`` (each entry holds
its own shard, the shards run one after another).  Inputs as in
``tests/test_sharded.py`` (``bench.py``'s ``make_bundle`` / ``build_inputs``,
D = 64, S = 20, M = 1024, B = 4, k = 16), with random biases.

* ``build_triple_index_sharded``: rtol 1e-5 / atol 1e-6
  (``tests/test_sharded.py:236-238``), and equal to the port's unsharded
  build.
* ``query_topk_sharded`` in f32: rtol 1e-5 / atol 1e-5, equal id sets
  (``tests/test_sharded.py:77-81``); equal to the port's unsharded
  ``query_topk`` id for id.
* ``query_topk_sharded_fused`` (kernel 2's plain version on each shard)
  against JAX's ``query_topk_sharded_fused(..., interpret=True)``: the
  set-overlap rule of ``tests/test_torch_pooled_query.py`` (slack 2, 0.02 +
  2%); against the port's unsharded ``query_topk_fused`` exactly (scores do
  not depend on the shard).
* Sizes that do not divide over the mesh raise ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bench import build_inputs, make_bundle
from evi_rag_tpu.ops import query as jq
from evi_rag_tpu.parallel.mesh import make_mesh as j_make_mesh
from evi_rag_tpu_torch.ops import query as tq
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.parallel.mesh import make_mesh
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

D, S, M, B, K = 64, 20, 1024, 4, 16
V, R = 512, 16
NDEV = 8


@pytest.fixture(scope="module")
def case():
    np_bundle = make_bundle(D, D, S, seed=5)
    rng = np.random.default_rng(5)
    for name in ("q_gate", "q_bias", "struct_proj", "state_net_0", "state_net_1", "score_head"):
        b = np_bundle["features"][name]["bias"]
        b[:] = 0.1 * rng.normal(size=b.shape)
    np_bundle["features"]["non_text_entity_emb"][:] = rng.normal(size=D)
    ins = build_inputs(M, D, S, B, seed=5)
    tables = dict(
        entity_emb=rng.normal(size=(V, D)).astype(np.float32),
        relation_emb=rng.normal(size=(R, D)).astype(np.float32),
        nontext_mask=rng.random(V) < 0.2,
        heads=rng.integers(0, V, M).astype(np.int32),
        rels=rng.integers(0, R, M).astype(np.int32),
        tails=rng.integers(0, V, M).astype(np.int32),
        struct_raw=ins["struct"],
    )
    jmesh = j_make_mesh(NDEV)
    return dict(
        jb=jax.tree.map(jnp.asarray, np_bundle),
        tb={"features": bundle_from_numpy(np_bundle["features"], device="cpu")},
        ins=ins, tables=tables, jmesh=jmesh, sh=NamedSharding(jmesh, P("data")),
        mesh=make_mesh(devices=["cpu"] * NDEV),
    )


def _j_index(c, rows):
    return jq.TripleIndex(*(jax.device_put(jnp.asarray(x), c["sh"]) for x in rows))


def _t_index(rows, dtype=torch.float32):
    return tq.TripleIndex(*(torch.as_tensor(x).to(dtype) for x in rows))


def _rows(c):
    i = c["ins"]
    return i["head"], i["rel"], i["tail"], i["struct"]


def test_sharded_index_build_matches_jax(case):
    c, t = case, case["tables"]
    ref = jq.build_triple_index_sharded(
        c["jb"], mesh=c["jmesh"], entity_emb=jax.device_put(jnp.asarray(t["entity_emb"]), c["sh"]),
        relation_emb=jnp.asarray(t["relation_emb"]), nontext_mask=jax.device_put(jnp.asarray(t["nontext_mask"]), c["sh"]),
        heads=jnp.asarray(t["heads"]), rels=jnp.asarray(t["rels"]), tails=jnp.asarray(t["tails"]),
        struct_raw=jnp.asarray(t["struct_raw"]))
    got = tq.build_triple_index_sharded(c["tb"], mesh=c["mesh"], **t)
    single = tq.build_triple_index(c["tb"], **t, device="cpu")
    for name in ("head_repr", "tail_repr", "rel_repr", "struct_raw"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(single, name).numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    # The non-text rows take the projected non-text entity row in every shard.
    nt = np.flatnonzero(t["nontext_mask"][t["heads"]])
    assert nt.size and np.allclose(got.head_repr[nt].numpy(), got.head_repr[nt[:1]].numpy())


def test_sharded_query_topk_matches_jax(case):
    c = case
    q = jnp.asarray(c["ins"]["q"])
    jv, ji = jq.query_topk_sharded(c["jb"], q, _j_index(c, _rows(c)), mesh=c["jmesh"], k=K, chunk=128,
                                   dtype=jnp.float32)
    tv, ti = tq.query_topk_sharded(c["tb"], torch.as_tensor(c["ins"]["q"]), _t_index(_rows(c)), mesh=c["mesh"],
                                   k=K, chunk=128, dtype=torch.float32)
    assert tv.shape == (B, K) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    for b in range(B):
        assert set(ti[b].tolist()) == set(np.asarray(ji[b]).tolist())
    uv, ui = tq.query_topk(c["tb"], torch.as_tensor(c["ins"]["q"]), _t_index(_rows(c)), k=K, chunk=128,
                           dtype=torch.float32, device="cpu")
    assert torch.equal(ti, ui)
    np.testing.assert_allclose(tv.numpy(), uv.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_fused_query_matches_jax_interpret(case):
    from evi_rag_tpu.ops.pallas_score import pallas_query_topk_fused

    c = case
    q = jnp.asarray(c["ins"]["q"])
    jv, ji = jq.query_topk_sharded_fused(c["jb"], q, _j_index(c, _rows(c)), mesh=c["jmesh"], k=K, bq=4,
                                         tile=128, interpret=True)
    jv1, ji1 = pallas_query_topk_fused(c["jb"], q, jq.TripleIndex(*(jnp.asarray(x) for x in _rows(c))), k=K, bq=4,
                                       tile=128, interpret=True)
    idx = _t_index(_rows(c), torch.bfloat16)
    tv, ti = tq.query_topk_sharded_fused(c["tb"], torch.as_tensor(c["ins"]["q"]), idx, mesh=c["mesh"], k=K)
    for ref_v, ref_i in ((jv, ji), (jv1, ji1)):
        ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
        for g in range(B):
            ref = dict(zip(ref_i[g].tolist(), ref_v[g].tolist()))
            got = dict(zip(ti[g].tolist(), tv[g].tolist()))
            common = set(ref) & set(got)
            assert len(common) >= K - 2, (g, set(ref) ^ set(got))
            for e in common:
                assert abs(ref[e] - got[e]) < 0.02 + 0.02 * abs(ref[e]), (g, e)
    # Per-candidate scores do not depend on the shard: the unsharded plain
    # version gives the same top-k.
    uv, ui = sk.query_topk_fused(c["tb"], torch.as_tensor(c["ins"]["q"]), idx, k=K)
    assert torch.equal(tv, uv) and torch.equal(ti, ui)


@pytest.mark.parametrize("which", ["build", "query", "fused"])
def test_uneven_shards_raise(case, which):
    c = case
    mesh = make_mesh(devices=["cpu"] * 3)
    q = torch.as_tensor(c["ins"]["q"])
    with pytest.raises(ValueError, match="divide evenly"):
        if which == "build":
            tq.build_triple_index_sharded(c["tb"], mesh=mesh, **c["tables"])
        elif which == "query":
            tq.query_topk_sharded(c["tb"], q, _t_index(_rows(c)), mesh=mesh, k=K, dtype=torch.float32)
        else:
            tq.query_topk_sharded_fused(c["tb"], q, _t_index(_rows(c), torch.bfloat16), mesh=mesh, k=K)
