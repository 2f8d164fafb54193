"""The gte-v1.5 "NewModel" text encoder (``Alibaba-NLP/gte-large-en-v1.5``,
the production text encoder of the build) in PyTorch.

Counterpart of ``evi_rag_tpu/data/gte_jax.py``: the same architecture, the
same checkpoint loading and the same ``encode`` contract.

* embeddings: word + ``token_type_embeddings[0]`` -> LayerNorm (no absolute
  positions);
* per layer (post-LN): fused ``qkv_proj``, rotate-half RoPE on q / k in f32
  over the padded length, scaled scores plus the additive
  ``finfo(float32).min`` mask, softmax, ``o_proj``,
  ``hidden = attn_ln(hidden + attn_out)``; gated MLP
  ``up, gate = split(up_gate_proj(x))``, ``down_proj(act(gate) * up)``,
  ``hidden = mlp_ln(hidden + mlp_out)``;
* masked mean pooling.

``GTEModel`` holds the upstream state-dict keys as its own
(``embeddings.{word_embeddings,token_type_embeddings,LayerNorm}``,
``encoder.layer.{i}.attention.{qkv_proj,o_proj}``,
``encoder.layer.{i}.{attn_ln,mlp_ln}``,
``encoder.layer.{i}.mlp.{up_gate_proj,down_proj}``).  The activation is the
JAX package's: ``hidden_act = "gelu*"`` is the tanh form
(``jax.nn.gelu``'s default), where upstream gte uses the exact erf form.
The model stays in f32: the additive ``finfo(float32).min`` mask is safe
only there.  The GEMMs and the attention are library calls.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evi_rag_tpu_torch.utils.device import resolve_device


class ReferenceEncoderUnavailable(RuntimeError):
    """The HF reference encoder cannot be built in this environment."""


@dataclasses.dataclass(frozen=True)
class GTEConfig:
    vocab_size: int
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    type_vocab_size: int = 2
    rope_theta: float = 160000.0
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_json(path: str | pathlib.Path) -> "GTEConfig":
        cfg = json.loads(pathlib.Path(path).read_text())
        return GTEConfig(
            vocab_size=int(cfg["vocab_size"]),
            hidden_size=int(cfg.get("hidden_size", 1024)),
            num_hidden_layers=int(cfg.get("num_hidden_layers", 24)),
            num_attention_heads=int(cfg.get("num_attention_heads", 16)),
            intermediate_size=int(cfg.get("intermediate_size", 4096)),
            type_vocab_size=int(cfg.get("type_vocab_size", 2)),
            rope_theta=float(cfg.get("rope_theta", 160000.0)),
            layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
            hidden_act=str(cfg.get("hidden_act", "gelu")),
        )


# ``jax.nn`` activations by name, as ``gte_forward`` looks them up.
_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu, "silu": F.silu, "swish": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "elu": F.elu, "selu": F.selu, "softplus": F.softplus,
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JAX package's activation for ``hidden_act``: every ``gelu*`` is
    ``jax.nn.gelu``, whose default is the tanh approximation."""
    if name.startswith("gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported hidden_act {name!r}")
    return _ACTIVATIONS[name]


def _strip_prefix(state: dict[str, Any]) -> dict[str, Any]:
    """Drop a leading ``new.``/``model.``/``bert.`` wrapper prefix if all
    keys share it (AutoModel vs task-head checkpoints differ here)."""
    for prefix in ("new.", "model.", "bert."):
        if all(k.startswith(prefix) for k in state):
            return {k[len(prefix):]: v for k, v in state.items()}
    return state


def load_gte_state_dict(model_dir: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Read the torch checkpoint (safetensors preferred) as f32 numpy arrays."""
    model_dir = pathlib.Path(model_dir)
    st_path = model_dir / "model.safetensors"
    if st_path.exists():
        from safetensors.numpy import load_file

        state = load_file(str(st_path))
    else:
        bins = sorted(model_dir.glob("pytorch_model*.bin"))
        if not bins:
            raise FileNotFoundError(f"no model.safetensors / pytorch_model*.bin in {model_dir}")
        state = {}
        for b in bins:
            part = torch.load(b, map_location="cpu", weights_only=True)
            state.update({k: v.float().numpy() for k, v in part.items()})
    return _strip_prefix({k: np.asarray(v, np.float32) for k, v in state.items()})


def _layer_keys(i: int) -> tuple[str, ...]:
    p = f"encoder.layer.{i}"
    return (f"{p}.attention.qkv_proj.weight", f"{p}.attention.o_proj.weight", f"{p}.attn_ln.weight",
            f"{p}.attn_ln.bias", f"{p}.mlp.up_gate_proj.weight", f"{p}.mlp.down_proj.weight",
            f"{p}.mlp_ln.weight", f"{p}.mlp_ln.bias")


def _optional_keys(i: int) -> tuple[str, ...]:
    p = f"encoder.layer.{i}"
    return (f"{p}.attention.qkv_proj.bias", f"{p}.attention.o_proj.bias", f"{p}.mlp.down_proj.bias")


class _Namespace(nn.Module):
    """A module that only groups children under a name of the state dict."""


class GTELayer(nn.Module):
    def __init__(self, cfg: GTEConfig, *, qkv_bias: bool, o_bias: bool, down_bias: bool) -> None:
        super().__init__()
        d, i, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.attention = _Namespace()
        self.attention.qkv_proj = nn.Linear(d, 3 * d, bias=qkv_bias)
        self.attention.o_proj = nn.Linear(d, d, bias=o_bias)
        self.attn_ln = nn.LayerNorm(d, eps=eps)
        self.mlp = _Namespace()
        self.mlp.up_gate_proj = nn.Linear(d, 2 * i, bias=False)
        self.mlp.down_proj = nn.Linear(i, d, bias=down_bias)
        self.mlp_ln = nn.LayerNorm(d, eps=eps)


class GTEModel(nn.Module):
    """``gte_forward`` as a module whose state-dict keys are upstream's.

    Build it with ``from_state_dict``: the biases and the token-type table
    are present where the checkpoint has them, as in ``convert_gte_params``."""

    def __init__(self, cfg: GTEConfig, *, token_types: bool = True, qkv_bias: bool = True,
                 o_bias: bool = True, down_bias: bool = True) -> None:
        super().__init__()
        self.cfg = cfg
        self.act = activation(cfg.hidden_act)
        d = cfg.hidden_size
        self.embeddings = _Namespace()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        if token_types:
            self.embeddings.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.embeddings.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder = _Namespace()
        self.encoder.layer = nn.ModuleList(
            GTELayer(cfg, qkv_bias=qkv_bias, o_bias=o_bias, down_bias=down_bias)
            for _ in range(cfg.num_hidden_layers))

    @classmethod
    def from_state_dict(cls, state: dict[str, Any], cfg: GTEConfig, *, device=None) -> "GTEModel":
        """The keys ``convert_gte_params`` reads (others are ignored) as the
        module's parameters, moved to ``device`` (the GPU unless ``"cpu"``).
        Numpy arrays are shared on the CPU and copied once to the card."""
        dev = resolve_device(device)
        keys = ["embeddings.word_embeddings.weight", "embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
        for i in range(cfg.num_hidden_layers):
            keys += _layer_keys(i)
        optional = ["embeddings.token_type_embeddings.weight"]
        for i in range(cfg.num_hidden_layers):
            optional += _optional_keys(i)
        keys += [k for k in optional if k in state]
        with torch.device("meta"):
            model = cls(cfg, token_types="embeddings.token_type_embeddings.weight" in state,
                        qkv_bias="encoder.layer.0.attention.qkv_proj.bias" in state,
                        o_bias="encoder.layer.0.attention.o_proj.bias" in state,
                        down_bias="encoder.layer.0.mlp.down_proj.bias" in state)
        tensors = {k: torch.as_tensor(state[k], dtype=torch.float32).to(dev) for k in keys}
        model.load_state_dict(tensors, strict=True, assign=True)
        return model.eval()

    def _rope(self, t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        d = self.cfg.head_dim
        inv_freq = 1.0 / (self.cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
        freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device), inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)  # [T, D_h]
        return emb.cos(), emb.sin()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Last hidden state [B, T, D] (f32) of ``input_ids`` [B, T]."""
        cfg, emb = self.cfg, self.embeddings
        b, t = input_ids.shape
        h, dh = cfg.num_attention_heads, cfg.head_dim
        x = emb.word_embeddings(input_ids)
        if hasattr(emb, "token_type_embeddings"):
            x = x + emb.token_type_embeddings.weight[0]
        x = emb.LayerNorm(x)
        neg = torch.finfo(torch.float32).min
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).to(torch.float32)
        cos, sin = self._rope(t, x.device)

        def rope(z):
            z1, z2 = z.chunk(2, dim=-1)
            return z * cos + torch.cat([-z2, z1], dim=-1) * sin

        for layer in self.encoder.layer:
            qkv = layer.attention.qkv_proj(x)
            q, k, v = (z.reshape(b, t, h, dh).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
            ctx = F.scaled_dot_product_attention(rope(q), rope(k), v, attn_mask=bias)
            x = layer.attn_ln(x + layer.attention.o_proj(ctx.transpose(1, 2).reshape(b, t, cfg.hidden_size)))
            up, gate = layer.mlp.up_gate_proj(x).chunk(2, dim=-1)
            x = layer.mlp_ln(x + layer.mlp.down_proj(self.act(gate) * up))
        return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    mask = attention_mask[..., None].to(hidden.dtype)
    return (hidden * mask).sum(1) / mask.sum(1).clamp(min=1.0)


def gte_params_from_jax(params: dict[str, Any], cfg: GTEConfig) -> dict[str, torch.Tensor]:
    """``convert_gte_params``' pytree (numpy leaves) back to the upstream
    state dict: the inverse of its key map and of its transposes."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    t = lambda a: f32(np.asarray(a).T)
    state = {
        "embeddings.word_embeddings.weight": f32(params["word_embeddings"]),
        "embeddings.LayerNorm.weight": f32(params["ln_emb_scale"]),
        "embeddings.LayerNorm.bias": f32(params["ln_emb_bias"]),
    }
    if "token_type_embeddings" in params:
        state["embeddings.token_type_embeddings.weight"] = f32(params["token_type_embeddings"])
    if len(params["layers"]) != cfg.num_hidden_layers:
        raise ValueError(f"{len(params['layers'])} layers in the pytree, {cfg.num_hidden_layers} in the config")
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}"
        state.update({
            f"{p}.attention.qkv_proj.weight": t(layer["qkv_w"]),
            f"{p}.attention.o_proj.weight": t(layer["o_w"]),
            f"{p}.attn_ln.weight": f32(layer["attn_ln_scale"]),
            f"{p}.attn_ln.bias": f32(layer["attn_ln_bias"]),
            f"{p}.mlp.up_gate_proj.weight": t(layer["up_gate_w"]),
            f"{p}.mlp.down_proj.weight": t(layer["down_w"]),
            f"{p}.mlp_ln.weight": f32(layer["mlp_ln_scale"]),
            f"{p}.mlp_ln.bias": f32(layer["mlp_ln_bias"]),
        })
        for name, key in (("qkv_b", "attention.qkv_proj.bias"), ("o_b", "attention.o_proj.bias"),
                          ("down_b", "mlp.down_proj.bias")):
            if name in layer:
                state[f"{p}.{key}"] = f32(layer[name])
    return state


class GTETextEncoder:
    """Mean-pooled gte encoder on the GPU (or ``device="cpu"``): a torch
    checkpoint directory in, ``encode`` out.  Every batch is padded to
    ``batch_size`` rows with ``""`` and every row to ``max_length`` tokens,
    as the JAX package pads for one compiled shape.  ``stats`` counts the
    texts, batches, real tokens (the mask of the texts' rows) and padded
    tokens (every position the model computes)."""

    def __init__(self, model_dir: str | pathlib.Path, *, max_length: int = 64, device=None) -> None:
        from evi_rag_tpu_torch.data.text_encoder import import_transformers

        dev = resolve_device(device)
        model_dir = pathlib.Path(model_dir)
        cfg = GTEConfig.from_json(model_dir / "config.json")
        tokenizer = import_transformers().AutoTokenizer.from_pretrained(str(model_dir))
        self._setup(GTEModel.from_state_dict(load_gte_state_dict(model_dir), cfg, device=dev), tokenizer,
                    max_length)

    @classmethod
    def from_model(cls, model: GTEModel, tokenizer, *, max_length: int = 64) -> "GTETextEncoder":
        """An encoder over a built model and a tokenizer (a callable with the
        HF signature that ``encode`` uses)."""
        enc = cls.__new__(cls)
        enc._setup(model, tokenizer, max_length)
        return enc

    def _setup(self, model: GTEModel, tokenizer, max_length: int) -> None:
        self.model = model
        self.config = model.cfg
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.dim = self.config.hidden_size
        self.device = model.embeddings.word_embeddings.weight.device
        self.stats = {"texts": 0, "batches": 0, "real_tokens": 0, "padded_tokens": 0}

    def encode(self, texts: Sequence[str], *, batch_size: int = 256) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i : i + batch_size])
            toks = self.tokenizer(
                chunk + [""] * (batch_size - len(chunk)),
                padding="max_length",
                truncation=True,
                max_length=self.max_length,
                return_tensors="np",
            )
            ids = torch.as_tensor(np.asarray(toks["input_ids"], np.int64), device=self.device)
            mask = torch.as_tensor(np.asarray(toks["attention_mask"], np.int64), device=self.device)
            with torch.inference_mode():
                emb = mean_pool(self.model(ids, mask), mask)
            out[i : i + len(chunk)] = emb[: len(chunk)].cpu().numpy()
            self.stats["texts"] += len(chunk)
            self.stats["batches"] += 1
            self.stats["real_tokens"] += int(np.asarray(toks["attention_mask"])[: len(chunk)].sum())
            self.stats["padded_tokens"] += int(ids.numel())
        return out

    def parity_check(self, model_dir: str | pathlib.Path, texts: Sequence[str]) -> float:
        """Min cosine similarity against the HF reference encoder
        (``TorchHFTextEncoder`` with the checkpoint's remote code) on the
        same checkpoint and device.

        Raises :class:`ReferenceEncoderUnavailable` when the reference cannot
        be *constructed* here (transformers absent, remote modeling code not
        on disk); failures while encoding or comparing propagate."""
        from evi_rag_tpu_torch.data.text_encoder import TorchHFTextEncoder

        try:
            ref = TorchHFTextEncoder(str(model_dir), max_length=self.max_length, trust_remote_code=True,
                                     device=str(self.device))
        except Exception as exc:  # any failure to build the reference downgrades the gate
            raise ReferenceEncoderUnavailable(
                f"HF reference encoder could not be constructed: {exc}"
            ) from exc
        a = self.encode(list(texts), batch_size=min(8, max(len(texts), 1)))
        b = ref.encode(list(texts))
        num = (a * b).sum(-1)
        den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        return float((num / np.maximum(den, 1e-9)).min())
