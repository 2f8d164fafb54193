"""Port vs JAX: padded graph batches, collation and the batch order.

``pad_graphs``, ``collate_retriever`` (dense and id-feed),
``iter_stacked_batches`` (shuffled with the same numpy generator) and the
bucket policy give bit-for-bit the JAX package's arrays, in the same order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.models import batches as jbatches
from evi_rag_tpu.ops import graph as jgraph
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.models import batches as tbatches
from evi_rag_tpu_torch.ops import graph as tgraph

from _torch_train_common import batches, datasets


def _assert_same(jobj, tobj, path="batch"):
    """Every field equal, value and dtype; None where JAX has None."""
    if dataclasses.is_dataclass(jobj):
        for f in dataclasses.fields(jobj):
            _assert_same(getattr(jobj, f.name), getattr(tobj, f.name), f"{path}.{f.name}")
        return
    if jobj is None:
        assert tobj is None, path
        return
    want, got = np.asarray(jobj), tobj.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("graphs", [4, 7])  # 7: empty slots before the padding graph
def test_pad_graphs_bit_for_bit(graphs):
    rng = np.random.default_rng(0)
    sizes = [5, 1, 9]
    ei = [rng.integers(0, n, size=(2, rng.integers(0, 12))).astype(np.int32) for n in sizes]
    kw = dict(edge_index=ei, num_nodes=sizes, bucket_graphs=graphs, bucket_nodes=32, bucket_edges=64)
    _assert_same(jgraph.pad_graphs(**kw), tgraph.pad_graphs(**kw))
    with pytest.raises(ValueError, match="graph slots"):
        tgraph.pad_graphs(**{**kw, "bucket_graphs": 3})
    vals = [rng.normal(size=(n, 2)) for n in sizes]
    np.testing.assert_array_equal(tgraph.scatter_node_values(vals, 32), jgraph.scatter_node_values(vals, 32))


@pytest.mark.parametrize("id_feed", [False, True])
def test_collate_retriever_bit_for_bit(id_feed):
    jds, tds = datasets(num_samples=6)
    bucket = jfeed.fixed_bucket_for(jds.samples, 4)
    assert dataclasses.asdict(bucket) == dataclasses.asdict(tfeed.fixed_bucket_for(tds.samples, 4))
    jb, tb = batches(jds, tds, 1, 5, bucket, id_feed=id_feed)
    _assert_same(jb, tb)
    np.testing.assert_array_equal(tb.edge_is_near.numpy(), np.asarray(jb.edge_is_near))
    if id_feed:
        jt = jbatches.make_tables(jds.entity_emb, jds.relation_emb)
        tt = tbatches.make_tables(tds.entity_emb, tds.relation_emb, device="cpu")
        np.testing.assert_array_equal(tt.entity.numpy(), np.asarray(jt.entity))
        _assert_same(jbatches.materialize_retriever_batch(jb, jt),
                     tbatches.materialize_retriever_batch(tb, tt))


@pytest.mark.parametrize("shards,per", [(1, 3), (2, 2)])
def test_iter_stacked_batches_same_order_and_arrays(shards, per):
    jds, tds = datasets(num_samples=9)
    kw = lambda ds: dict(num_shards=shards, per_shard_batch=per, entity_emb=ds.entity_emb,
                         relation_emb=ds.relation_emb, question_emb=ds.question_emb, seed=5)
    jlist = list(jfeed.iter_stacked_batches(jds.samples, **kw(jds)))
    tlist = list(tfeed.iter_stacked_batches(tds.samples, **kw(tds)))
    assert len(tlist) == len(jlist) == 9 // (shards * per)
    for jb, tb in zip(jlist, tlist):
        _assert_same(jb, tb)
    # A shard of a stacked batch is the flat batch of its samples.
    _assert_same(jax.tree.map(lambda x: x[shards - 1], jlist[0]), tlist[0].shard(shards - 1))


def test_bucket_policy_and_flat_iteration_match():
    for x in (1, 128, 129, 1000, 4097):
        assert tfeed.round_up_pow2(x) == jfeed.round_up_pow2(x)
    assert (dataclasses.asdict(tfeed.Bucket.for_batch(16, 9000, 26000))
            == dataclasses.asdict(jfeed.Bucket.for_batch(16, 9000, 26000)))
    jds, tds = datasets(num_samples=7)
    kw = lambda ds: dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                         question_emb=ds.question_emb, batch_size=3, shuffle=True, seed=2)
    for jb, tb in zip(jfeed.iter_retriever_batches(jds.samples, **kw(jds)),
                      tfeed.iter_retriever_batches(tds.samples, **kw(tds)), strict=True):
        _assert_same(jb, tb)
    assert list(tfeed.prefetch(iter(range(5)))) == list(range(5))


def test_batch_to_moves_every_tensor():
    jds, tds = datasets(num_samples=2)
    _, tb = batches(jds, tds, 0, 2, tfeed.Bucket(graphs=3, nodes=64, edges=128), id_feed=True)
    moved = tgraph.batch_to(tb, torch.device("cpu"))
    assert moved.node_emb is None and moved.graph.edge_index.dtype == torch.int32
