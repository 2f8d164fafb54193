"""The weights of the ``moonlight`` configuration's LLM, drawn by the
benchmark from the seed (card, one ``torch.Generator`` a tensor), so that
the reason cell holds the program to weights it did not draw itself.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any


def moonlight_layout(c: dict[str, Any]) -> dict[str, tuple[int, ...]]:
    """Name -> shape of the weights of a ``deepseek_v3`` configuration ``c``
    (its published keys), in ``reference/moonlight.py``'s names, matrices
    [out, in]."""
    d, h, r, dr = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    e, ie, dense = c["n_routed_experts"], c["moe_intermediate_size"], c["intermediate_size"]
    shared = c["n_shared_experts"] * ie
    out = {"embed": (c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        dn, dv = c["qk_nope_head_dim"], c["v_head_dim"]
        out.update({p + "input_norm": (d,), p + "post_norm": (d,), p + "q_proj": (h * (dn + dr), d),
                    p + "kv_a": (r + dr, d), p + "kv_norm": (r,), p + "kv_b": (h * (dn + dv), r),
                    p + "o_proj": (d, h * dv)})
        if i >= c["first_k_dense_replace"]:
            out.update({p + "router": (e, d), p + "router_bias": (e,), p + "experts.gate_up": (e, 2 * ie, d),
                        p + "experts.down": (e, d, ie), p + "shared.gate_up": (2 * shared, d),
                        p + "shared.down": (d, shared)})
        else:
            out.update({p + "gate_up": (2 * dense, d), p + "down": (d, dense)})
    out.update({"norm": (d,), "lm_head": (c["vocab_size"], d)})
    return out


class MoonlightWeights(Mapping):
    """The weights of a ``deepseek_v3`` configuration from ``seed``, drawn
    on ``device`` each time one is read, from a generator of its own (a
    tensor reads the same whatever else was read, and nothing is held):
    matrices N(0, 0.02) and RMSNorm scales 1 + N(0, 0.05), both rounded to
    bf16; the router bias (``e_score_correction_bias``) N(0, 0.05) in f32,
    uneven routing that does not collapse."""

    def __init__(self, seed: int, c: dict[str, Any], device):
        self.seed, self.device = int(seed), device
        self.layout = moonlight_layout(c)
        self.index = {k: i for i, k in enumerate(self.layout)}

    def __getitem__(self, name: str):
        import torch

        shape = self.layout[name]
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + 7_919 * (self.index[name] + 1)) % (1 << 62))
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        if name.endswith("router_bias"):
            return x.mul_(0.05)
        if name.endswith("norm"):
            return x.mul_(0.05).add_(1.0).to(torch.bfloat16)
        return x.mul_(0.02).to(torch.bfloat16)

    def __iter__(self):
        return iter(self.layout)

    def __len__(self) -> int:
        return len(self.layout)
