"""The model files of the reasoner's language models: the keys of each
published ``config.json``, read verbatim.

``MoonlightConfig.from_dict`` takes every key the published configuration of
Moonlight-16B-A3B (``deepseek_v3``) holds and ``KimiLinearConfig.from_dict``
every key of Kimi-Linear-48B-A3B's (``kimi_linear``); each refuses, by
name, a key it does not know or a value it does not implement (a low-rank q
projection, group-limited routing, another scoring function).  ``seq_aux``
names a training loss and changes nothing at inference.

Both give the shared layers (``models/llm/moonlight.py``: MLA, the router,
the experts) the same names: ``router_experts`` (the experts the router
scores), ``n_routed_experts`` (the experts held here: ids 0 ..
n_routed_experts - 1 of the router's), ``num_experts_per_tok``,
``norm_topk_prob``, ``shared_width`` and ``max_positions``.
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
        cfg = _read(cls, d, FIXED)
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

    @property
    def router_experts(self) -> int:
        return self.n_routed_experts

    @property
    def max_positions(self) -> int:
        return self.max_position_embeddings

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


def _read(cls, d: dict[str, Any], fixed: dict[str, Any]):
    """``cls`` from model file ``d``: unknown keys, values other than
    ``fixed``'s and missing keys refused by name."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields - set(fixed))
    if unknown:
        raise ValueError(f"model file: keys not implemented: {unknown}")
    for key, want in fixed.items():
        if key in d and d[key] != want:
            raise ValueError(f"model file: {key}={d[key]!r} is not implemented (only {want!r})")
    missing = sorted(f.name for f in dataclasses.fields(cls)
                     if f.default is dataclasses.MISSING and f.name not in d)
    if missing:
        raise ValueError(f"model file: keys missing: {missing}")
    return cls(**{k: d[k] for k in fields if k in d})


KIMI_FIXED = {
    "model_type": "kimi_linear",
    "hidden_act": "silu",
    "q_lora_rank": None,
    "mla_use_nope": True,
    "moe_router_activation_func": "sigmoid",
    "use_grouped_topk": True,
    "num_expert_group": 1,
    "topk_group": 1,
    "moe_layer_freq": 1,
    "num_nextn_predict_layers": 0,
    "rope_scaling": None,
    "tie_word_embeddings": False,
}
LINEAR_ATTN_KEYS = {"full_attn_layers", "kda_layers", "num_heads", "head_dim", "short_conv_kernel_size"}


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    """Kimi-Linear-48B-A3B's ``config.json``.  ``linear_attn_config`` lists
    the KDA layers and the MLA (``full_attn_layers``) layers 1-indexed, as
    published.  ``num_experts`` counts the experts held here and
    ``router_experts`` (absent: the same) the experts the router scores.
    ``head_dim`` (hidden / heads) is used by neither attention and
    ``rope_theta`` by no layer (MLA without rotation)."""

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
    num_experts: int
    num_shared_experts: int
    num_experts_per_token: int
    first_k_dense_replace: int
    moe_renormalize: bool
    routed_scaling_factor: float
    rms_norm_eps: float
    vocab_size: int
    model_max_length: int
    linear_attn_config: dict
    head_dim: int | None = None
    rope_theta: float | None = None
    router_experts: int | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KimiLinearConfig":
        cfg = _read(cls, d, KIMI_FIXED)
        lin = cfg.linear_attn_config
        if set(lin) != LINEAR_ATTN_KEYS:
            raise ValueError(f"model file: linear_attn_config keys {sorted(lin)} are not {sorted(LINEAR_ATTN_KEYS)}")
        kinds = sorted(list(lin["kda_layers"]) + list(lin["full_attn_layers"]))
        if kinds != list(range(1, cfg.num_hidden_layers + 1)):
            raise ValueError("model file: kda_layers and full_attn_layers must split layers 1..num_hidden_layers")
        if cfg.num_key_value_heads != cfg.num_attention_heads:
            raise ValueError("model file: num_key_value_heads must equal num_attention_heads (MLA)")
        if lin["short_conv_kernel_size"] < 1:
            raise ValueError("model file: short_conv_kernel_size must be at least 1")
        if cfg.router_experts is None:
            object.__setattr__(cfg, "router_experts", cfg.num_experts)
        if not 0 < cfg.num_experts <= cfg.router_experts or cfg.num_experts_per_token > cfg.router_experts:
            raise ValueError(f"model file: num_experts {cfg.num_experts} held of router_experts "
                             f"{cfg.router_experts} with {cfg.num_experts_per_token} a token")
        return cfg

    @classmethod
    def from_file(cls, path: str | pathlib.Path) -> "KimiLinearConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    # The shared layers' names (module docstring).
    n_routed_experts = property(lambda self: self.num_experts)
    n_shared_experts = property(lambda self: self.num_shared_experts)
    num_experts_per_tok = property(lambda self: self.num_experts_per_token)
    norm_topk_prob = property(lambda self: self.moe_renormalize)
    max_positions = property(lambda self: self.model_max_length)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def shared_width(self) -> int:
        return self.moe_intermediate_size * self.num_shared_experts

    @property
    def kda_heads(self) -> int:
        return int(self.linear_attn_config["num_heads"])

    @property
    def kda_dim(self) -> int:
        return int(self.linear_attn_config["head_dim"])

    @property
    def kda_width(self) -> int:
        """P: the heads' widths side by side."""
        return self.kda_heads * self.kda_dim

    @property
    def conv_size(self) -> int:
        return int(self.linear_attn_config["short_conv_kernel_size"])

    def is_kda(self, layer: int) -> bool:
        """Whether 0-indexed ``layer`` is a KDA layer."""
        return layer + 1 in self.linear_attn_config["kda_layers"]

    @property
    def kda_layers(self) -> list[int]:
        return [i for i in range(self.num_hidden_layers) if self.is_kda(i)]

    @property
    def mla_layers(self) -> list[int]:
        return [i for i in range(self.num_hidden_layers) if not self.is_kda(i)]

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

