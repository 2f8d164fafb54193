"""Port vs JAX: the text encoders (``data/text_encoder.py``).

The hash encoder and ``encode_to_memmap`` are bit for bit JAX's; the HF
encoder on a tiny ``BertModel`` checkpoint (``device="cpu"``) gives what the
JAX package's torch encoder gives.  The HF encoder runs on the GPU unless
the CPU is named, and says so when ``transformers`` is missing.
"""

import sys

import numpy as np
import pytest
import torch

from evi_rag_tpu.data import text_encoder as jt
from evi_rag_tpu_torch.data import text_encoder as tt

TEXTS = ["barack obama", "Barack  Obama", "paris france", "", "people.person.place_of_birth",
         "héllo wörld", "Entity 1234 Film", "m.0abc1"]


@pytest.mark.parametrize("dim,ngram,seed", [(16, 3, 0), (256, 3, 0), (64, 2, 7)])
def test_hash_encoder_bit_for_bit(dim, ngram, seed):
    got = tt.HashTextEncoder(dim, ngram=ngram, seed=seed).encode(TEXTS)
    want = jt.HashTextEncoder(dim, ngram=ngram, seed=seed).encode(TEXTS)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert tt.HashTextEncoder(dim).encode([]).shape == jt.HashTextEncoder(dim).encode([]).shape == (0, dim)


@pytest.mark.parametrize("reserve_row0,batch_size", [(True, 3), (False, 3), (True, 256)])
def test_encode_to_memmap_bit_for_bit(tmp_path, reserve_row0, batch_size):
    got = tt.encode_to_memmap(tt.HashTextEncoder(32), TEXTS, tmp_path / "t" / "e.npy", batch_size=batch_size,
                              reserve_row0=reserve_row0)
    want = jt.encode_to_memmap(jt.HashTextEncoder(32), TEXTS, tmp_path / "j" / "e.npy", batch_size=batch_size,
                               reserve_row0=reserve_row0)
    assert got.shape == (len(TEXTS) + reserve_row0, 32)
    assert (tmp_path / "t" / "e.npy").read_bytes() == (tmp_path / "j" / "e.npy").read_bytes()
    if reserve_row0:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / "e.npy")[0], 0.0)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    from transformers import BertConfig, BertModel, BertTokenizerFast

    d = tmp_path_factory.mktemp("bert")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "barack", "obama", "paris", "france", "people",
             ".", "person", "place", "_", "of", "birth", "entity", "film"]
    (d / "vocab.txt").write_text("\n".join(words))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(str(d))
    cfg = BertConfig(vocab_size=len(words), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    BertModel(cfg).save_pretrained(str(d), safe_serialization=False)
    return str(d)


@pytest.mark.parametrize("trust_remote_code,batch_size", [(False, 3), (True, 256)])
def test_hf_encoder_matches_jax(bert_dir, trust_remote_code, batch_size):
    got = tt.TorchHFTextEncoder(bert_dir, max_length=16, trust_remote_code=trust_remote_code,
                                device="cpu").encode(TEXTS, batch_size=batch_size)
    want = jt.TorchHFTextEncoder(bert_dir, max_length=16, trust_remote_code=trust_remote_code).encode(
        TEXTS, batch_size=batch_size)
    assert got.shape == want.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_hf_encoder_needs_a_named_cpu_or_a_gpu(bert_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.TorchHFTextEncoder(bert_dir)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="needs the `transformers` package"):
        tt.TorchHFTextEncoder(bert_dir, device="cpu")
