"""Frozen text encoders for the entity / relation / question embeddings.

Counterpart of ``evi_rag_tpu/data/text_encoder.py``:

* ``HashTextEncoder`` -- the dependency-free feature-hashing encoder of
  tests and offline builds, bit for bit the JAX package's;
* ``TorchHFTextEncoder`` -- a HF ``AutoModel`` with attention-mask mean
  pooling.  It is also the port's counterpart of the JAX package's
  ``FlaxHFTextEncoder`` (the same checkpoint through torch instead of flax,
  ``trust_remote_code=False``).  It runs on the GPU unless the caller asks
  for ``device="cpu"``; ``transformers`` is imported only when one is made;
* ``encode_to_memmap`` -- streams an encoder's rows into a ``.npy`` memmap
  with row 0 reserved (zeros) for non-text entities.

Every encoder has ``dim`` and ``encode(texts, batch_size=256) -> [N, dim]``
float32.  The gte-v1.5 encoder is ``data/gte.py``.
"""

from __future__ import annotations

import hashlib
import pathlib
from typing import Protocol, Sequence

import numpy as np


class TextEncoder(Protocol):
    dim: int

    def encode(self, texts: Sequence[str], *, batch_size: int = 256) -> np.ndarray: ...


class HashTextEncoder:
    """Deterministic feature-hashing encoder (offline/test fallback)."""

    def __init__(self, dim: int = 256, *, ngram: int = 3, seed: int = 0) -> None:
        self.dim = int(dim)
        self.ngram = int(ngram)
        self.seed = int(seed)

    def _features(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float32)
        toks = text.lower().split()
        grams = list(toks)
        joined = " ".join(toks)
        grams += [joined[i : i + self.ngram] for i in range(max(len(joined) - self.ngram + 1, 0))]
        for g in grams:
            h = hashlib.blake2b(f"{self.seed}:{g}".encode(), digest_size=8).digest()
            idx = int.from_bytes(h[:4], "little") % self.dim
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def encode(self, texts: Sequence[str], *, batch_size: int = 256) -> np.ndarray:
        return np.stack([self._features(t) for t in texts]) if texts else np.zeros((0, self.dim), np.float32)


def import_transformers():
    """``transformers``, or an ImportError that says which encoders need it."""
    try:
        import transformers
    except ImportError as exc:
        raise ImportError(
            "this text encoder needs the `transformers` package (a HF tokenizer and model); "
            "build.encoder.kind=hash needs none"
        ) from exc
    return transformers


class TorchHFTextEncoder:
    """HF ``AutoModel`` + attention-mask mean pooling over a local
    checkpoint, on ``device`` (the GPU unless ``"cpu"``)."""

    def __init__(
        self,
        model_path: str,
        *,
        max_length: int = 64,
        trust_remote_code: bool = True,
        device: str | None = None,
    ) -> None:
        import torch

        from evi_rag_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        transformers = import_transformers()
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(
            model_path, trust_remote_code=trust_remote_code
        )
        self.model = transformers.AutoModel.from_pretrained(
            model_path, trust_remote_code=trust_remote_code
        ).to(self.device)
        self.model.eval()
        self.max_length = int(max_length)
        self.dim = int(self.model.config.hidden_size)
        self._torch = torch

    def encode(self, texts: Sequence[str], *, batch_size: int = 256) -> np.ndarray:
        torch = self._torch
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        with torch.no_grad():
            for i in range(0, len(texts), batch_size):
                chunk = list(texts[i : i + batch_size])
                toks = self.tokenizer(
                    chunk,
                    padding=True,
                    truncation=True,
                    max_length=self.max_length,
                    return_tensors="pt",
                ).to(self.device)
                hidden = self.model(**toks).last_hidden_state
                mask = toks["attention_mask"].unsqueeze(-1).to(hidden.dtype)
                emb = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1.0)
                out[i : i + len(chunk)] = emb.float().cpu().numpy()
        return out


def encode_to_memmap(
    encoder: TextEncoder,
    texts: Sequence[str],
    out_path: str | pathlib.Path,
    *,
    batch_size: int = 256,
    reserve_row0: bool = True,
) -> np.ndarray:
    """Stream-encode into a .npy memmap; row 0 reserved for non-text entities."""
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    offset = 1 if reserve_row0 else 0
    n = len(texts) + offset
    arr = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=np.float32, shape=(n, encoder.dim)
    )
    if reserve_row0:
        arr[0] = 0.0
    for i in range(0, len(texts), batch_size):
        chunk = list(texts[i : i + batch_size])
        arr[offset + i : offset + i + len(chunk)] = encoder.encode(chunk, batch_size=batch_size)
    arr.flush()
    return arr
