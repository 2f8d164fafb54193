"""Port vs JAX: the segment ops the loss and the metrics use.

The same numpy inputs (a fully masked segment, an empty one, a padding
segment last) go through ``evi_rag_tpu.ops.segment`` and the port's
``ops/segment.py``.  Values at f32 rtol 1e-4 / atol 1e-5; gradients of the
differentiable ones (sum, mean, logsumexp, softmax) finite and at the same
tolerance; argmax ids and integer min exact.

The sum's two passes over chunks of ``CHUNK_ROWS`` rows, on segments of up
to ten chunks and a padding segment last, as the training bucket has them:
a segment of at most ``CHUNK_ROWS`` rows bit for bit one
``torch.segment_reduce`` pass, a longer one at f32 tolerance of a float64
sum, repeats bit for bit, gradients exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.ops import segment as jseg
from evi_rag_tpu_torch.ops import segment as tseg

from evi_rag_tpu_torch.utils import profiling

from _torch_train_common import F32

G, E = 6, 48
C = tseg.CHUNK_ROWS


def _inputs(seed, width=None):
    rng = np.random.default_rng(seed)
    shape = (E,) if width is None else (E, width)
    data = rng.normal(size=shape).astype(np.float32)
    ids = np.sort(rng.choice([0, 1, 2, 3, 5], size=E)).astype(np.int32)  # segment 4 empty
    ids[-6:] = G - 1                                                     # padding segment
    mask = rng.random(E) < 0.7
    mask[ids == 2] = False                                               # fully masked segment
    mask[ids == G - 1] = False
    data[3] = data[5]                                                    # a tie
    return data, ids, mask


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max", "segment_min"])
@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_reductions_match_jax(op, width, masked):
    data, ids, mask = _inputs(1, width)
    m = mask if masked else None
    want = getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), G,
                             mask=None if m is None else jnp.asarray(m))
    got = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids), G,
                            mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_count_and_integer_min_match_jax():
    data, ids, mask = _inputs(2)
    np.testing.assert_array_equal(
        tseg.segment_count(torch.from_numpy(ids), G, mask=torch.from_numpy(mask)).numpy(),
        np.asarray(jseg.segment_count(jnp.asarray(ids), G, mask=jnp.asarray(mask))))
    ints = (np.abs(data) * 100).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.segment_min(torch.from_numpy(ints), torch.from_numpy(ids), G, fill=999).numpy(),
        np.asarray(jseg.segment_min(jnp.asarray(ints), jnp.asarray(ids), G, fill=999)))


@pytest.mark.parametrize("masked", [False, True])
def test_argmax_matches_jax_with_lowest_index_ties(masked):
    data, ids, mask = _inputs(3)
    m = mask if masked else None
    jv, ja = jseg.segment_argmax(jnp.asarray(data), jnp.asarray(ids), G,
                                 mask=None if m is None else jnp.asarray(m))
    tv, ta = tseg.segment_argmax(torch.from_numpy(data), torch.from_numpy(ids), G,
                                 mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tied = torch.zeros(4), torch.tensor([0, 0, 1, 1])
    assert tseg.segment_argmax(*tied, 3)[1].tolist() == [0, 2, 0]


@pytest.mark.parametrize("op", ["segment_logsumexp", "segment_softmax", "segment_sum", "segment_mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_values_and_gradients_match_jax(op, masked):
    data, ids, mask = _inputs(4)
    w = np.random.default_rng(5).normal(size=G if op != "segment_softmax" else E).astype(np.float32)
    m = mask if masked else None

    def jfn(x):
        out = getattr(jseg, op)(x, jnp.asarray(ids), G, mask=None if m is None else jnp.asarray(m))
        # Empty segments give NEG_INF: weight only the finite outputs.
        return jnp.sum(jnp.where(out > jseg.NEG_INF, out, 0.0) * w), out

    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_(True)
    out = getattr(tseg, op)(x, torch.from_numpy(ids), G, mask=None if m is None else torch.from_numpy(m))
    (torch.where(out > tseg.NEG_INF, out, torch.zeros_like(out)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **F32)
    if op == "segment_logsumexp":
        assert (out[[2, 4]] == tseg.NEG_INF).all() if masked else out[4] == tseg.NEG_INF


def test_gather_rows_matches_jax_take_and_its_gradient():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    idx = rng.integers(0, 7, size=40).astype(np.int32)
    w = rng.normal(size=(40, 3)).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda a: jnp.sum(a[jnp.asarray(idx)] * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tseg.gather_rows(xt, torch.from_numpy(idx))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), x[idx])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **F32)


# Segment lengths in sorted order: short ones, one empty, one of exactly C
# rows, three longer, and the padding segment of 10 C + 7 rows last.
CHUNK_LENGTHS = [5, 0, C, C + 1, 40, 3 * C + 2, 10 * C + 7]


def _chunk_inputs(width, masked):
    rng = np.random.default_rng(7)
    n = sum(CHUNK_LENGTHS)
    data = rng.normal(size=(n,) if width is None else (n, width)).astype(np.float32)
    ids = np.repeat(np.arange(len(CHUNK_LENGTHS)), CHUNK_LENGTHS).astype(np.int32)
    perm = rng.permutation(n)  # unsorted ids, as gather_rows' indices come
    mask = np.ones(n, bool)
    if masked:
        mask = rng.random(n) < 0.8
        mask[ids == 4] = False  # a fully masked segment
    return data[perm], ids[perm], mask[perm]


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_sum_orders_and_gradients(width, masked):
    data, ids, mask = _chunk_inputs(width, masked)
    g = len(CHUNK_LENGTHS)
    x, tids, tmask = torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(mask) if masked else None
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tseg.segment_sum(x, tids, g, mask=tmask)
    k = -(-len(ids) // C) + g + 1
    assert profiling.totals()["counters"] == {"segment.sum.chunks": k}
    _, layout = tseg.segment_layout(tids, g, mask=tmask)
    assert layout.chunk_lengths.shape == (k,) and int(layout.chunk_counts.sum()) == k
    assert int(layout.chunk_lengths.max()) <= C and int(layout.chunk_lengths.sum()) == len(ids)
    spare = layout.chunk_counts - (layout.lengths + C - 1) // C  # empty chunks: at most one a segment
    assert int(spare.min()) == 0 and int(spare.max()) == 1

    valid = np.sort(ids[mask], kind="stable")
    lengths = np.bincount(valid, minlength=g)
    rows = data[np.argsort(np.where(mask, ids, g), kind="stable")][: len(valid)]
    one_pass = torch.segment_reduce(torch.from_numpy(rows), "sum", lengths=torch.from_numpy(lengths), axis=0)
    short = torch.from_numpy(lengths <= C)
    assert torch.equal(got[short], one_pass[short])
    assert (lengths > C).sum() >= 2
    want = np.stack([rows[e - n:e].astype(np.float64).sum(0) for n, e in zip(lengths, np.cumsum(lengths))])
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert torch.equal(got, tseg.segment_sum(x, tids, g, mask=tmask))
    if masked:
        assert (got[4] == 0).all()

    w = torch.from_numpy(np.random.default_rng(8).normal(size=got.shape).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    (tseg.segment_sum(xg, tids, g, mask=tmask) * w).sum().backward()
    keep = torch.from_numpy(mask).reshape((-1,) + (1,) * (x.ndim - 1))
    assert torch.equal(xg.grad, torch.where(keep, w[tids.long()], torch.zeros(())))


@pytest.mark.parametrize("width", [1, 3])
def test_gather_rows_gradient_over_a_long_padding_segment_matches_jax(width):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(7, width)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, 6, size=300), np.full(10 * C + 7, 6)]).astype(np.int32)
    w = rng.normal(size=(len(idx), width)).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(a[jnp.asarray(idx)] * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tseg.gather_rows(xt, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **F32)
