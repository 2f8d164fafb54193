"""The weights of the ``kimi_linear`` configuration's LLM, drawn by the
benchmark from the seed (card, one ``torch.Generator`` a tensor), so that
the cell holds the program to weights it did not draw itself.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

from benchmarks.llm_weights import moonlight_layout


def kimi_layout(c: dict[str, Any]) -> dict[str, tuple[int, ...]]:
    """Name -> shape of the weights of a ``kimi_linear`` configuration ``c``
    (its published keys and ``router_experts``), in
    ``reference/kimi_linear.py``'s names, matrices [out, in]: a KDA layer's
    projections, convolution taps, gates and norm; an MLA layer's and every
    MLP or MoE as in ``moonlight_layout`` (the router scores
    ``router_experts``, ``num_experts`` held)."""
    lin = c["linear_attn_config"]
    h, d, taps = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    dim, width = c["hidden_size"], h * lin["head_dim"]
    held, scored = c["num_experts"], c.get("router_experts") or c["num_experts"]
    mla = moonlight_layout(dict(c, n_routed_experts=held, n_shared_experts=c["num_shared_experts"]))
    out = {}
    for name, shape in mla.items():
        if not name.startswith("layers."):
            out[name] = shape
            continue
        i, part = int(name.split(".")[1]), name.split(".", 2)[2]
        if i + 1 in lin["kda_layers"] and part in ("q_proj", "kv_a", "kv_norm", "kv_b", "o_proj"):
            continue
        out[name] = (scored, *shape[1:]) if part in ("router", "router_bias") else shape
        if part == "post_norm" and i + 1 in lin["kda_layers"]:
            p = f"layers.{i}."
            for n in ("q", "k", "v"):
                out[p + n + "_proj"] = (width, dim)
                out[p + n + "_conv"] = (width, taps)
            out.update({p + "b_proj": (h, dim), p + "f_a": (d, dim), p + "f_b": (width, d), p + "A_log": (h,),
                        p + "dt_bias": (width,), p + "g_a": (d, dim), p + "g_b": (width, d), p + "o_norm": (d,),
                        p + "o_proj": (dim, width)})
    return out


class KimiWeights(Mapping):
    """The weights of a ``kimi_linear`` configuration from ``seed``, drawn
    on ``device`` each time one is read, from a generator of its own (a
    tensor reads the same whatever else was read, and nothing is held):
    matrices N(0, 0.02) and RMSNorm scales 1 + N(0, 0.05), both rounded to
    bf16; convolution taps N(0, 0.25) in bf16; in f32 A_log = log U(1, 16),
    dt_bias = softplus^-1 of U(0.001, 0.1) and the router bias
    (``e_score_correction_bias``) N(0, 0.05)."""

    def __init__(self, seed: int, c: dict[str, Any], device):
        self.seed, self.device = int(seed), device
        self.layout = kimi_layout(c)
        self.index = {k: i for i, k in enumerate(self.layout)}

    def __getitem__(self, name: str):
        import torch

        shape = self.layout[name]
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + 7_919 * (self.index[name] + 1)) % (1 << 62))
        if name.endswith(("A_log", "dt_bias")):
            u = torch.rand(shape, generator=gen, device=self.device, dtype=torch.float32)
            if name.endswith("A_log"):
                return u.mul_(15.0).add_(1.0).log_()
            dt = u.mul_(0.099).add_(0.001)
            return dt + torch.log(-torch.expm1(-dt))
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        if name.endswith("router_bias"):
            return x.mul_(0.05)
        if name.endswith("norm"):
            return x.mul_(0.05).add_(1.0).to(torch.bfloat16)
        if name.endswith("_conv"):
            return x.mul_(0.25).to(torch.bfloat16)
        return x.mul_(0.02).to(torch.bfloat16)

    def __iter__(self):
        return iter(self.layout)

    def __len__(self) -> int:
        return len(self.layout)
