"""Port vs JAX: the gte-v1.5 encoder (``data/gte.py`` vs ``data/gte_jax.py``).

The same random state dict (made from a seed) goes through the JAX
``gte_forward`` and the port's ``GTEModel`` at a small geometry (2 layers,
hidden 32, 2 heads, intermediate 48): the last hidden state and the pooled
output agree at rtol 1e-4 / atol 1e-5 (f32).  The weight converters, the
checkpoint loader and the encoders' ``encode`` are held to JAX's too, and the
build's parity gate refuses a diverging encoder.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_build_common import GTE_TINY, write_fixture, write_tiny_gte
from evi_rag_tpu.data import gte_jax as jg
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.data import gte as tg
from evi_rag_tpu_torch.testing import random_gte_state

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
RTOL, ATOL = 1e-4, 1e-5
TEXTS = ["who directed the film inception", "capital of france", "a question about the city of berlin",
         "short", "", "which award"]


def _state(minimal: bool, seed: int = 0) -> dict[str, np.ndarray]:
    state = {k: v.numpy() for k, v in random_gte_state(tg.GTEConfig(**GTE_TINY), seed).items()}
    if minimal:  # no biases of the projections and no token-type table
        state = {k: v for k, v in state.items() if not (k.endswith(("proj.bias",)) or "token_type" in k)}
    return state


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, GTE_TINY["vocab_size"], size=(4, 16))
    mask = np.zeros((4, 16), np.int64)
    for row, n in enumerate((16, 9, 2, 5)):  # ragged, one row of [CLS] [SEP] only
        mask[row, :n] = 1
    return ids, mask


def _both(state, cfg_kw):
    ids, mask = _inputs()
    jcfg, tcfg = jg.GTEConfig(**cfg_kw), tg.GTEConfig(**cfg_kw)
    params = jg.convert_gte_params(state, jcfg)
    jh = np.asarray(jg.gte_forward(params, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))
    model = tg.GTEModel.from_state_dict(state, tcfg, device="cpu")
    with torch.no_grad():
        th = model(torch.as_tensor(ids), torch.as_tensor(mask))
        tp = tg.mean_pool(th, torch.as_tensor(mask)).numpy()
    m = mask[..., None].astype(np.float32)
    jp = (jh * m).sum(1) / np.maximum(m.sum(1), 1.0)
    return jh, th.numpy(), jp, tp, model


@pytest.mark.parametrize("minimal,act", [(False, "gelu"), (True, "gelu"), (False, "silu"), (False, "relu")])
def test_model_matches_gte_forward(minimal, act):
    state = _state(minimal)
    jh, th, jp, tp, model = _both(state, {**GTE_TINY, "hidden_act": act})
    assert sorted(model.state_dict()) == sorted(state)
    np.testing.assert_allclose(th, jh, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("minimal", [False, True])
def test_params_from_jax_give_back_the_state_dict(minimal):
    state = _state(minimal, seed=3)
    params = jax.tree_util.tree_map(np.asarray, jg.convert_gte_params(state, jg.GTEConfig(**GTE_TINY)))
    back = tg.gte_params_from_jax(params, tg.GTEConfig(**GTE_TINY))
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert back[key].dtype == torch.float32
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("keys", [["new.a", "new.b"], ["model.a", "model.b"], ["bert.a", "bert.b"],
                                  ["new.a", "model.b"], ["a", "new.b"]])
def test_strip_prefix_matches_jax(keys):
    state = {k: i for i, k in enumerate(keys)}
    assert tg._strip_prefix(dict(state)) == jg._strip_prefix(dict(state))


@pytest.mark.parametrize("fmt", ["bin", "bin_prefixed", "safetensors"])
def test_load_state_dict_matches_jax(fmt, tmp_path):
    state = {k: torch.as_tensor(v) for k, v in _state(False, seed=5).items()}
    if fmt == "bin":
        torch.save(state, tmp_path / "pytorch_model.bin")
    elif fmt == "bin_prefixed":
        half = len(state) // 2
        items = [(f"new.{k}", v) for k, v in state.items()]
        torch.save(dict(items[:half]), tmp_path / "pytorch_model-00001-of-00002.bin")
        torch.save(dict(items[half:]), tmp_path / "pytorch_model-00002-of-00002.bin")
    else:
        from safetensors.torch import save_file

        save_file(state, str(tmp_path / "model.safetensors"))
    got, want = tg.load_gte_state_dict(tmp_path), jg.load_gte_state_dict(tmp_path)
    assert sorted(got) == sorted(want) == sorted(state)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(FileNotFoundError):
        tg.load_gte_state_dict(tmp_path / "missing")


@pytest.fixture(scope="module")
def gte_dir(tmp_path_factory):
    return write_tiny_gte(tmp_path_factory.mktemp("gte") / "tiny", seed=1)


@pytest.mark.parametrize("batch_size", [4, 256])
def test_encoder_matches_jax(gte_dir, batch_size):
    """``encode`` pads every batch to ``batch_size`` rows with "" and every
    row to ``max_length``, as JAX does."""
    want = jg.GTEJaxTextEncoder(gte_dir, max_length=24).encode(TEXTS, batch_size=batch_size)
    enc = tg.GTETextEncoder(gte_dir, max_length=24, device="cpu")
    got = enc.encode(TEXTS, batch_size=batch_size)
    assert got.shape == want.shape == (len(TEXTS), GTE_TINY["hidden_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    batches = -(-len(TEXTS) // batch_size)
    assert enc.stats["texts"] == len(TEXTS) and enc.stats["padded_tokens"] == batches * batch_size * 24


def test_tanh_and_erf_gelu_differ_by_a_bounded_gap():
    """The JAX package's gte uses ``jax.nn.gelu`` (tanh form) where upstream
    gte uses the exact erf form; the port computes the JAX form.  At the
    small geometry the two forms part by ~3e-4 in the pooled output (max
    abs), a cosine above 0.999 (the JAX test's bar)."""
    state = _state(False, seed=2)
    _, th, jp, tp, model = _both(state, GTE_TINY)
    ids, mask = _inputs()
    model.act = lambda x: F.gelu(x, approximate="none")
    with torch.no_grad():
        erf = tg.mean_pool(model(torch.as_tensor(ids), torch.as_tensor(mask)), torch.as_tensor(mask)).numpy()
    gap = float(np.abs(erf - tp).max())
    cos = (erf * tp).sum(-1) / (np.linalg.norm(erf, axis=-1) * np.linalg.norm(tp, axis=-1))
    print(f"tanh-erf GELU gap at the small geometry: max abs {gap:.3e}, min cosine {cos.min():.8f}")
    assert 1e-5 < gap < 1e-2 and cos.min() > 0.999
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)  # the port stays on JAX's form


class _Ref:
    """A stand-in for the HF reference encoder."""

    def __init__(self, model_path, *, max_length, trust_remote_code, device):
        self.inner = tg.GTETextEncoder(model_path, max_length=max_length, device=device)

    def encode(self, texts, batch_size=256):
        return self.inner.encode(texts, batch_size=8) * 2.0  # the same direction


def test_parity_check_semantics(gte_dir, monkeypatch):
    from evi_rag_tpu_torch.data import text_encoder

    enc = tg.GTETextEncoder(gte_dir, max_length=24, device="cpu")
    with pytest.raises(tg.ReferenceEncoderUnavailable):  # model_type "new" has no code on disk
        enc.parity_check(gte_dir, TEXTS[:4])
    monkeypatch.setattr(text_encoder, "TorchHFTextEncoder", _Ref)
    assert enc.parity_check(gte_dir, TEXTS[:4]) == pytest.approx(1.0, abs=1e-6)
    monkeypatch.setattr(_Ref, "encode", lambda self, texts, batch_size=256: 1 / 0)
    with pytest.raises(ZeroDivisionError):  # a failure while comparing is not a skip
        enc.parity_check(gte_dir, TEXTS[:4])


def test_build_gate_refuses_a_diverging_encoder(gte_dir, tmp_path, monkeypatch):
    """``build`` with ``encoder.kind=gte_jax`` refuses below
    ``parity_min_cosine``, builds above it, and skips the gate loudly when
    the reference cannot be constructed (this tiny checkpoint)."""
    from evi_rag_tpu_torch.utils.config import ConfigError, load_config

    raw = write_fixture("rog", tmp_path)
    cfg = load_config(CONFIGS, "build", [f"build.raw_root={raw}", f"build.out_dir={tmp_path / 'norm'}",
                                         "build.encoder.kind=gte_jax", f"build.encoder.model_path={gte_dir}",
                                         "device=cpu"])
    run = tmp_path / "run"
    run.mkdir()
    monkeypatch.setattr(tg.GTETextEncoder, "parity_check", lambda self, p, t: 0.42)
    with pytest.raises(ConfigError, match="parity FAILED"):
        tcli.task_build.__wrapped__(cfg, run_dir=run)
    assert not (tmp_path / "norm").exists()
    monkeypatch.setattr(tg.GTETextEncoder, "parity_check", lambda self, p, t: 0.99999)
    assert tcli.task_build.__wrapped__(cfg, run_dir=run)["num_entities"] > 0
    monkeypatch.undo()
    m = tcli.task_build.__wrapped__(cfg, run_dir=run)
    ent = np.load(tmp_path / "norm" / "embeddings" / "entity_embeddings.npy")
    assert ent.shape[1] == GTE_TINY["hidden_size"] and m["num_text_entities"] == ent.shape[0] - 1
    assert json.loads((run / "metrics.json").read_text()) == m
