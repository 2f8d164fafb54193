"""Port vs JAX: the frozen-feature nn primitives (``ops/nnfn.py``).

Same numpy inputs through both packages.  f32 tolerance rtol 1e-5 (the two
CPU backends sum matrix products in different orders); bf16 results are held
to one bf16 ulp of headroom (rtol 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.ops import nnfn as jnn
from evi_rag_tpu_torch.ops import nnfn as tnn

D, H, B = 64, 96, 12


def _dense_params(rng, i, o):
    return {
        "kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
        "bias": rng.normal(size=(o,)).astype(np.float32) * 0.1,
    }


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(B, D)).astype(np.float32),
        "dense": _dense_params(rng, D, H),
        "proj": {"proj": _dense_params(rng, D, D)},
        "ln": {"scale": rng.normal(size=(H,)).astype(np.float32),
               "bias": rng.normal(size=(H,)).astype(np.float32)},
        "z": (3.0 * rng.normal(size=(B, H)) + 1.0).astype(np.float32),
        "split": _dense_params(rng, 2 * D + 1, H),
    }


@pytest.mark.parametrize("fn", ["dense", "projector", "gelu_exact", "layernorm"])
def test_primitive_matches_jax_f32(data, fn):
    if fn == "dense":
        want = jnn.dense(_j(data["dense"]), jnp.asarray(data["x"]))
        got = tnn.dense(_t(data["dense"]), torch.as_tensor(data["x"]))
    elif fn == "projector":
        want = jnn.projector(_j(data["proj"]), jnp.asarray(data["x"]))
        got = tnn.projector(_t(data["proj"]), torch.as_tensor(data["x"]))
    elif fn == "gelu_exact":
        want = jnn.gelu_exact(jnp.asarray(data["z"]))
        got = tnn.gelu_exact(torch.as_tensor(data["z"]))
    else:
        want = jnn.layernorm(_j(data["ln"]), jnp.asarray(data["z"]))
        got = tnn.layernorm(_t(data["ln"]), torch.as_tensor(data["z"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dense_promotes_bf16_input_like_jax(data):
    """bf16 activations against f32 weights promote to f32 in both."""
    xb = jnp.asarray(data["x"]).astype(jnp.bfloat16)
    want = jnn.dense(_j(data["dense"]), xb)
    got = tnn.dense(_t(data["dense"]), torch.as_tensor(data["x"]).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_split_matches_jax(data, dtype):
    """Per-slice cast, f32 accumulation, one rounding at the end."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(B, D)).astype(np.float32)
    b = rng.normal(size=(B, D)).astype(np.float32)
    c = rng.normal(size=(B, 1)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jnn.dense_split(_j(data["split"]), tuple(map(jnp.asarray, (a, b, c))), jdt)
    got = tnn.dense_split(_t(data["split"]), tuple(map(torch.as_tensor, (a, b, c))), tdt)
    assert got.dtype == tdt
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=rtol
    )


def test_dense_split_rejects_row_mismatch(data):
    with pytest.raises(ValueError, match="parts sum"):
        tnn.dense_split(_t(data["split"]), (torch.zeros(B, D),), torch.float32)
