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


def _split_case(case):
    """(kernel, bias, parts) at D, H, B: parts as the retriever's
    ``state_net_0`` gets them (bf16 interaction | struct ctx | error, the
    width-1 distance), or f32 parts beside bf16 ones as the plain scorer
    gets them, or with a leading group axis."""
    rng = np.random.default_rng(2)
    p = _dense_params(rng, 3 * D + 1, H)
    kernel, bias = torch.as_tensor(p["kernel"]), torch.as_tensor(p["bias"])
    lead = (3, B) if case == "grouped" else (B,)
    dts = (torch.float32, torch.bfloat16, torch.float32, torch.float32) if case == "mixed" else (torch.bfloat16,) * 4
    parts = tuple(torch.as_tensor(rng.normal(size=(*lead, d)).astype(np.float32)).to(dt)
                  for d, dt in zip((D, D, D, 1), dts))
    return kernel, bias, parts


@pytest.mark.parametrize("case", ["retriever", "mixed", "grouped", "checkpoint"])
def test_dense_split_bf16_function_matches_the_f32_chain_bit_for_bit(case):
    """``DenseSplitBF16`` with the CPU's product against autograd through
    ``dense_split_f32`` at bf16: the output and the gradients of every
    part, the kernel and the bias equal bit for bit (also recomputed under
    ``torch.utils.checkpoint``, as ``remat=True`` runs it)."""
    kernel, bias, parts = _split_case(case)
    w = torch.as_tensor(np.random.default_rng(3).normal(size=(*parts[0].shape[:-1], H)).astype(np.float32))

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (kernel, bias, *parts)]
        out = fn(*leaves)
        grads = torch.autograd.grad((out.float() * w).sum(), leaves)
        return out, grads

    chain = lambda k, b, *xs: tnn.dense_split_f32({"kernel": k, "bias": b}, xs, torch.bfloat16)
    fn = tnn.DenseSplitBF16.apply
    if case == "checkpoint":
        fn = lambda *a: torch.utils.checkpoint.checkpoint(tnn.DenseSplitBF16.apply, *a, use_reentrant=False)
    want, want_grads = run(chain)
    got, got_grads = run(fn)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)
    for name, g, ref in zip(["kernel", "bias", "part0", "part1", "part2", "part3"], got_grads, want_grads):
        assert g.dtype == ref.dtype and torch.equal(g, ref), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_split_off_the_card_counts_the_f32_route(dtype):
    """Only bf16 on CUDA takes the tensor-core route: off the card, f32 and
    bf16 alike count ``nnfn.dense_split.f32``, once per call."""
    from torch.profiler import ProfilerActivity, profile

    from evi_rag_tpu_torch.utils import profiling

    kernel, bias, parts = _split_case("retriever")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            tnn.dense_split({"kernel": kernel, "bias": bias}, parts, dtype)
    assert profiling.totals()["counters"] == {"nnfn.dense_split.f32": 2}
    profiling.reset()
