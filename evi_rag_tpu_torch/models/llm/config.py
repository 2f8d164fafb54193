"""The model file of a ``deepseek_v3`` language model: the keys of its
published ``config.json``, read verbatim.

``MoonlightConfig.from_dict`` takes every key the published configuration of
Moonlight-16B-A3B holds and refuses, by name, a key it does not know or a
value it does not implement (a low-rank q projection, group-limited
routing, another scoring function).  ``seq_aux`` names a training loss and
changes nothing at inference.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

# Keys whose only implemented value is fixed: (key, value).
FIXED = {
    "model_type": "deepseek_v3",
    "hidden_act": "silu",
    "attention_bias": False,
    "q_lora_rank": None,
    "scoring_func": "sigmoid",
    "topk_method": "noaux_tc",
    "n_group": 1,
    "topk_group": 1,
    "ep_size": 1,
    "moe_layer_freq": 1,
    "num_nextn_predict_layers": 0,
    "tie_word_embeddings": False,
}


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    norm_topk_prob: bool
    routed_scaling_factor: float
    rms_norm_eps: float
    rope_theta: float
    vocab_size: int
    max_position_embeddings: int
    seq_aux: bool = True

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MoonlightConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields - set(FIXED))
        if unknown:
            raise ValueError(f"model file: keys not implemented: {unknown}")
        for key, want in FIXED.items():
            if key in d and d[key] != want:
                raise ValueError(f"model file: {key}={d[key]!r} is not implemented (only {want!r})")
        missing = sorted(f.name for f in dataclasses.fields(cls)
                         if f.default is dataclasses.MISSING and f.name not in d)
        if missing:
            raise ValueError(f"model file: keys missing: {missing}")
        cfg = cls(**{k: d[k] for k in fields if k in d})
        if cfg.num_key_value_heads != cfg.num_attention_heads:
            raise ValueError("model file: num_key_value_heads must equal num_attention_heads (MLA)")
        if cfg.qk_rope_head_dim % 2:
            raise ValueError("model file: qk_rope_head_dim must be even")
        return cfg

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "MoonlightConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a latent cache row: the compressed kv and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def shared_width(self) -> int:
        return self.moe_intermediate_size * self.n_shared_experts

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace
