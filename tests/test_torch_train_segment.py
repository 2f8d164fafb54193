"""Port vs JAX: the segment ops the loss and the metrics use.

The same numpy inputs (a fully masked segment, an empty one, a padding
segment last) go through ``evi_rag_tpu.ops.segment`` and the port's
``ops/segment.py``.  Values at f32 rtol 1e-4 / atol 1e-5; gradients of the
differentiable ones (sum, mean, logsumexp, softmax) finite and at the same
tolerance; argmax ids and integer min exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.ops import segment as jseg
from evi_rag_tpu_torch.ops import segment as tseg

from _torch_train_common import F32

G, E = 6, 48


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
