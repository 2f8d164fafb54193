"""Per-question triple scoring with exact top-k, in plain PyTorch.

Counterpart of the serving half of ``evi_rag_tpu/ops/query.py`` (the XLA
path): ``_query_context``, ``_score_chunk`` and ``query_topk_per_question``,
with the same casts, so bf16 rounds where the JAX path rounds.  Serving uses
it for buckets below the kernel threshold and for every f32 request.

Per (query q, candidate (h, r, t, struct)):

    r_ctx  = r * sigmoid(Wg q) + tanh(Wb q)
    score  = score_head(state_net([h*r_ctx*t*nav | struct_ctx | h+r_ctx-t |
                                   -|h+r_ctx-t|]))

scored in both directions and combined by a two-way softmax.
"""

from __future__ import annotations

from typing import Any

import torch

from evi_rag_tpu_torch.ops.nnfn import (
    dense as _dense,
    dense_split as _dense_split,
    gelu_exact as _gelu_exact,
    layernorm as _layernorm,
    projector as _projector,
)
from evi_rag_tpu_torch.ops.score_kernels import topk_desc


def _query_context(feats: dict[str, Any], q_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query tensors: (projected query, gate, bias) -- computed once."""
    q = _projector(feats["query_proj"], q_emb)
    return q, torch.sigmoid(_dense(feats["q_gate"], q)), torch.tanh(_dense(feats["q_bias"], q))


def _score_chunk(
    feats: dict[str, Any],
    gate: torch.Tensor,     # [..., D], broadcast over the candidate axis
    bias: torch.Tensor,     # [..., D]
    h: torch.Tensor,        # [..., C, D]
    r: torch.Tensor,
    t: torch.Tensor,
    struct_raw: torch.Tensor,  # [..., C, S]
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[..., C] scores for one direction over one candidate chunk."""
    h = h.to(dtype)
    r = r.to(dtype)
    t = t.to(dtype)
    r_ctx = r * gate.to(dtype).unsqueeze(-2) + bias.to(dtype).unsqueeze(-2)
    struct_ctx = _gelu_exact(
        _layernorm(feats["struct_norm"], _dense(feats["struct_proj"], struct_raw.to(dtype)))
    )
    nav = torch.sigmoid(_dense(feats["struct_gate"], struct_ctx))
    inter = h * r_ctx * t * nav
    err = h + r_ctx - t
    dist = -torch.sqrt((err * err).float().sum(dim=-1, keepdim=True) + 1e-12)
    z = _gelu_exact(_layernorm(
        feats["state_norm"],
        _dense_split(feats["state_net_0"], (inter, struct_ctx, err, dist), dtype),
    ))
    z = _dense(feats["state_net_1"], z)
    return _dense(feats["score_head"], z)[..., 0].float()


def query_topk_per_question(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,        # [G, D] question embeddings
    head_repr: torch.Tensor,    # [G, M, D] per-question candidate rows (padded)
    rel_repr: torch.Tensor,     # [G, M, D]
    tail_repr: torch.Tensor,    # [G, M, D]
    struct_raw: torch.Tensor,   # [G, M, S]
    edge_valid: torch.Tensor,   # [G, M] bool (False on padding)
    *,
    k: int,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each question scores only its own candidates and keeps a local top-k,
    ordered (score desc, index asc).  Padding scores are -inf, so ``k`` may
    exceed a question's edge count.  Returns ([G, k] f32 scores, [G, k]
    int32 local candidate ids)."""
    feats = bundle["features"]
    s_dim = struct_raw.shape[-1] // 2
    _, gate, bias = _query_context(feats, q_emb)
    fwd = _score_chunk(feats, gate, bias, head_repr, rel_repr, tail_repr, struct_raw, dtype=dtype)
    s_swap = torch.cat([struct_raw[..., s_dim:], struct_raw[..., :s_dim]], dim=-1)
    bwd = _score_chunk(feats, gate, bias, tail_repr, rel_repr, head_repr, s_swap, dtype=dtype)
    stacked = torch.stack([fwd, bwd])
    w = torch.softmax(stacked, dim=0)
    scores = torch.where(
        edge_valid.bool(), (w * stacked).sum(dim=0), torch.full_like(fwd, float("-inf"))
    )
    return topk_desc(scores, k)
