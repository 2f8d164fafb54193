"""Port vs JAX: the ``Retriever`` module.

* The parameter tree has flax's names, shapes and dtypes (``kernel`` as
  [in, out]); JAX parameters load into the module and come back out
  unchanged, with the JAX digest; the port's initial draws have flax's
  moments (within 5%).
* The f32 forward gives the JAX module's logits, per-direction logits and
  edge embeddings at rtol 1e-4 / atol 1e-5 in all three direction modes,
  and in train mode with JAX's own dropout and hide-and-seek draws fed in.
* The bf16 forward stays within a bf16 tolerance (rtol 2e-2 / atol 2e-2 on
  O(1) values; the two packages round bf16 at the same points but order f32
  sums differently and compute GELU / tanh / sigmoid of bf16 inputs with
  their own roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu_torch.data.feeder import Bucket
from evi_rag_tpu_torch.models.retriever import (
    flax_path,
    init_parameters,
    load_params,
    params_to_numpy,
)
from evi_rag_tpu_torch.train import checkpoint as tck

from _torch_train_common import F32, batches, datasets, init_both, models, to_np

BUCKET = Bucket(graphs=5, nodes=64, edges=128)  # padding nodes and edges included
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def data():
    jds, tds = datasets(num_samples=4)
    return batches(jds, tds, 0, 4, BUCKET)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def test_parameter_tree_is_flax_and_round_trips(data):
    jb, _ = data
    jm, tm = models()
    params = init_both(jm, tm, jb)
    want = {p: (v.shape, v.dtype) for p, v in _leaves(params)}
    got = {flax_path(n): (tuple(p.shape), p.detach().numpy().dtype) for n, p in tm.named_parameters()}
    assert got == want
    out = params_to_numpy(tm)
    for p, v in _leaves(params):
        np.testing.assert_array_equal(dict(_leaves(out))[p], v)
    assert tck.params_digest(out) == jck.params_digest(params)
    with pytest.raises(KeyError, match="missing"):
        load_params(tm, {"params": {"q_gate": params["params"]["q_gate"]}})


def test_init_moments_match_flax():
    """Kernels: lecun_normal (std sqrt(1/fan_in), cut at 2 std of the
    underlying normal); non-text embedding: normal(1)."""
    jds, tds = datasets(num_samples=1, emb_dim=256)
    jb, _ = batches(jds, tds, 0, 1, BUCKET)
    jm, tm = models(emb_dim=256, hidden_dim=256)
    jparams = dict(_leaves(jax.tree.map(np.asarray, jm.init(jax.random.key(3), jb))))
    init_parameters(tm, torch.Generator().manual_seed(3))
    tparams = {flax_path(n): p.detach().numpy() for n, p in tm.named_parameters()}

    def moments(tree):
        z = np.concatenate([v.ravel() / np.sqrt(1.0 / v.shape[0]) for p, v in tree.items() if p.endswith("kernel")])
        return z.mean(), z.std(), np.abs(z).max(), tree["params/non_text_entity_emb"].std()

    jmean, jstd, jmax, jnt = moments(jparams)
    tmean, tstd, tmax, tnt = moments(tparams)
    assert abs(tmean) < 0.05 and abs(tstd - jstd) < 0.05 * jstd and abs(tstd - 1.0) < 0.05
    assert tmax <= 2.0 / 0.87962566103423978 + 1e-6 and jmax <= 2.0 / 0.87962566103423978 + 1e-6
    assert abs(tnt - jnt) < 0.15 and abs(tnt - 1.0) < 0.15
    for p, v in tparams.items():
        if p.endswith("bias") or p.endswith("scale"):
            np.testing.assert_array_equal(v, jparams[p])


@pytest.mark.parametrize("mode", ["bidirectional", "forward", "backward"])
def test_f32_forward_matches_jax(data, mode):
    jb, tb = data
    jm, tm = models(direction_mode=mode)
    params = init_both(jm, tm, jb, seed=1)
    want = jm.apply(params, jb)
    with torch.no_grad():
        got = tm(tb)
    for field in ("logits", "logits_fwd", "logits_bwd", "edge_embeddings"):
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   err_msg=field, **F32)


def _record(monkeypatch, name):
    calls = []
    real = getattr(jax.random, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, name, wrapped)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_with_jax_draws(data, monkeypatch, dtype):
    """Dropout (a mask per direction) and hide-and-seek with JAX's draws."""
    jb, tb = data
    hs = dict(hide_seek_enabled=True, hide_seek_p_near=0.7, hide_seek_p_far=0.3,
              hide_seek_bias_near=-2.0, hide_seek_bias_far=-0.5)
    jm, tm = models(dropout_p=0.3, compute_dtype=dtype, **hs)
    params = init_both(jm, tm, jb, seed=2)
    masks, uniforms = _record(monkeypatch, "bernoulli"), _record(monkeypatch, "uniform")
    want = jm.apply(params, jb, train=True,
                    rngs={"dropout": jax.random.key(4), "hide_seek": jax.random.key(5)})
    assert len(masks) == 2 and len(uniforms) == 1 and not np.array_equal(masks[0], masks[1])
    draws = {"dropout": tuple(torch.from_numpy(m) for m in masks), "hide_seek": torch.from_numpy(uniforms[0])}
    with torch.no_grad():
        got = tm(tb, train=True, draws=draws)
    tol = F32 if dtype == "float32" else BF16
    for field in ("logits", "logits_fwd", "logits_bwd", "edge_embeddings"):
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field)),
                                   err_msg=field, **tol)
    # The draws matter: without them the port draws its own.
    assert tm.make_draws(tb, train=True, generator=torch.Generator().manual_seed(0)).keys() == draws.keys()


def test_bf16_forward_matches_jax(data):
    jb, tb = data
    jm, tm = models(compute_dtype="bfloat16")
    params = init_both(jm, tm, jb, seed=3)
    want = jm.apply(params, jb)
    with torch.no_grad():
        got = tm(tb)
    assert got.edge_embeddings.dtype == torch.float32 and got.logits.dtype == torch.float32
    for field in ("logits", "logits_fwd", "logits_bwd", "edge_embeddings"):
        np.testing.assert_allclose(to_np(getattr(got, field)), np.asarray(getattr(want, field), np.float32),
                                   err_msg=field, **BF16)
    assert jnp.asarray(want.logits).dtype == jnp.float32
