"""Port vs JAX: segment reductions and DDE struct features.

Graphs carry padded, masked edges (pointing at a dump node, as serving pads
them).  Tolerance: exact up to 1 f32 ulp (rtol 2e-7): both sides sum the same
fractions, but JAX's dense one-hot path and the port's sorted segment sum
may add them in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.models.dde import build_node_struct_features as j_struct, dde_diffuse as j_dde
from evi_rag_tpu.ops.segment import segment_count as j_count, segment_mean as j_mean, segment_sum as j_sum
from evi_rag_tpu_torch.models.dde import build_node_struct_features as t_struct, dde_diffuse as t_dde
from evi_rag_tpu_torch.ops.segment import segment_count as t_count, segment_mean as t_mean, segment_sum as t_sum
from evi_rag_tpu_torch.serving import edge_struct_features

TOL = dict(rtol=2e-7, atol=0.0)


def _padded_graph(sample, n_pad, m_pad):
    """Topic one-hot [n_pad, 2], edge_index [2, m_pad] (padding -> dump node
    n_pad-1), edge mask [m_pad]."""
    e = sample.edge_index.shape[1]
    ei = np.full((2, m_pad), n_pad - 1, np.int32)
    ei[:, :e] = sample.edge_index
    mask = np.zeros(m_pad, bool)
    mask[:e] = True
    topic = np.zeros((n_pad, 2), np.float32)
    topic[sample.topic_locals, 0] = 1.0
    rest = np.ones(n_pad, bool)
    rest[sample.topic_locals] = False
    rest[sample.num_nodes :] = False
    topic[rest, 1] = 1.0
    return topic, ei, mask


@pytest.fixture(scope="module")
def graphs():
    ds = make_synthetic_dataset(num_samples=4, emb_dim=8, min_nodes=20, max_nodes=60, seed=3)
    return [_padded_graph(s, 256, 512) for s in ds.samples]


@pytest.mark.parametrize("num_segments", [16, 300])  # JAX dense and scatter paths
def test_segment_sum_count_mean_match_jax(num_segments):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(200, 3)).astype(np.float32)
    ids = rng.integers(0, num_segments - 3, size=200).astype(np.int32)  # last 3 empty
    mask = rng.random(200) < 0.7
    for jf, tf in ((j_sum, t_sum), (j_mean, t_mean)):
        want = jf(jnp.asarray(data), jnp.asarray(ids), num_segments, mask=jnp.asarray(mask))
        got = tf(torch.as_tensor(data), torch.as_tensor(ids), num_segments, mask=torch.as_tensor(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want_c = j_count(jnp.asarray(ids), num_segments, mask=jnp.asarray(mask))
    got_c = t_count(torch.as_tensor(ids), num_segments, mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # Masked elements contribute nothing; empty segments give 0.
    assert (t_mean(torch.as_tensor(data), torch.as_tensor(ids), num_segments)[-3:] == 0).all()


def test_segment_sum_on_padded_dde_inputs_matches_jax(graphs):
    """One DDE round's sum (messages from heads, summed at tails, padded
    edges masked) matches JAX within 1 ulp, and repeats bit for bit."""
    for topic, ei, mask in graphs:
        msgs = topic[ei[0]]
        want = j_sum(jnp.asarray(msgs), jnp.asarray(ei[1]), topic.shape[0], mask=jnp.asarray(mask))
        args = (torch.as_tensor(msgs), torch.as_tensor(ei[1]), topic.shape[0])
        got = t_sum(*args, mask=torch.as_tensor(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert torch.equal(got, t_sum(*args, mask=torch.as_tensor(mask)))
        assert (got[-1] == 0).all()  # the dump node receives only masked edges


def test_dde_diffuse_matches_jax(graphs):
    for topic, ei, mask in graphs:
        want = j_dde(jnp.asarray(topic), jnp.asarray(ei), num_rounds=2, num_reverse_rounds=2,
                     edge_mask=jnp.asarray(mask))
        got = t_dde(torch.as_tensor(topic), torch.as_tensor(ei), num_rounds=2, num_reverse_rounds=2,
                    edge_mask=torch.as_tensor(mask))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("rounds", [(2, 2), (4, 1), (0, 3)])
def test_build_node_struct_features_matches_jax(graphs, rounds):
    r, rr = rounds
    for topic, ei, mask in graphs:
        want = j_struct(jnp.asarray(topic), jnp.asarray(ei), num_rounds=r,
                        num_reverse_rounds=rr, edge_mask=jnp.asarray(mask))
        got = t_struct(torch.as_tensor(topic), torch.as_tensor(ei), num_rounds=r,
                       num_reverse_rounds=rr, edge_mask=torch.as_tensor(mask))
        assert got.shape == (topic.shape[0], 2 * (1 + r + rr))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dde_round_cap():
    with pytest.raises(ValueError, match="at most 4"):
        t_dde(torch.zeros(4, 2), torch.zeros(2, 3, dtype=torch.long), num_rounds=5, num_reverse_rounds=0)


def test_edge_struct_features_batched_equals_per_graph(graphs):
    """Serving's batched DDE (graphs laid end to end) equals the per-graph
    pass followed by the head/tail gather, i.e. JAX's vmapped ``struct_of``."""
    topic = torch.as_tensor(np.stack([g[0] for g in graphs]))
    ei = torch.as_tensor(np.stack([g[1] for g in graphs]))
    mask = torch.as_tensor(np.stack([g[2] for g in graphs]))
    got = edge_struct_features(topic, ei, mask, num_rounds=2, num_reverse_rounds=2)
    for g, (tp, e, m) in enumerate(graphs):
        ns = j_struct(jnp.asarray(tp), jnp.asarray(e), num_rounds=2, num_reverse_rounds=2,
                      edge_mask=jnp.asarray(m))
        want = jnp.concatenate([ns[e[0]], ns[e[1]]], axis=-1)
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want), **TOL)
