"""Triple scoring with exact top-k, in plain PyTorch.

Counterpart of ``evi_rag_tpu/ops/query.py`` (the XLA path), with the same
casts, so bf16 rounds where the JAX path rounds:

* the serving half -- ``_query_context``, ``_score_chunk`` and
  ``query_topk_per_question``; serving uses it for buckets below the kernel
  threshold and for every f32 request;
* the pooled index-and-query engine -- ``TripleIndex``,
  ``build_triple_index``, ``query_topk`` (a chunked running top-k) and
  ``score_all``: many queries over one shared candidate set.  The
  hand-written kernels of the same engine are
  ``ops.score_kernels.query_topk_per_query`` and ``query_topk_fused``.

Per (query q, candidate (h, r, t, struct)):

    r_ctx  = r * sigmoid(Wg q) + tanh(Wb q)
    score  = score_head(state_net([h*r_ctx*t*nav | struct_ctx | h+r_ctx-t |
                                   -|h+r_ctx-t|]))

scored in both directions and combined by a two-way softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from evi_rag_tpu_torch.ops.nnfn import (
    dense as _dense,
    dense_split as _dense_split,
    gelu_exact as _gelu_exact,
    layernorm as _layernorm,
    projector as _projector,
    tree_to,
)
from evi_rag_tpu_torch.ops.score_kernels import topk_desc
from evi_rag_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TripleIndex:
    """Device-resident, projection-pre-applied candidate store."""

    head_repr: torch.Tensor    # [M, D] projected entity reprs (tanh proj applied)
    rel_repr: torch.Tensor     # [M, D]
    tail_repr: torch.Tensor    # [M, D]
    struct_raw: torch.Tensor   # [M, S] raw edge structural features (DDE)

    @property
    def num_candidates(self) -> int:
        return self.head_repr.shape[0]

    def to(self, device: torch.device | None = None, dtype: torch.dtype | None = None) -> "TripleIndex":
        """The same index on ``device`` and / or cast to ``dtype`` (bf16 for
        the kernels: cast once, as ``bench.py``'s ``index_dtype`` does)."""
        conv = lambda x: x.to(device=device, dtype=dtype).contiguous()
        return TripleIndex(*(conv(getattr(self, f.name)) for f in dataclasses.fields(self)))


def _as(x: Any, dev: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


@torch.inference_mode()
def build_triple_index(
    bundle: dict[str, Any],
    *,
    entity_emb: Any,      # [V, D] raw text embeddings
    relation_emb: Any,    # [R, D]
    nontext_mask: Any,    # [V] bool
    heads: Any,           # [M] entity ids
    rels: Any,            # [M] relation ids
    tails: Any,           # [M]
    struct_raw: Any,      # [M, S]
    device: str | torch.device | None = None,
) -> TripleIndex:
    """Project the tables once, then gather per-candidate rows (index
    build).  Rows that ``nontext_mask`` flags take the projected non-text
    entity row.  Returns an f32 index on ``device`` (cuda unless ``"cpu"``
    is asked for)."""
    dev = resolve_device(device)
    feats = tree_to(bundle["features"], dev)
    f32 = torch.float32
    ent = _projector(feats["entity_proj"], _as(entity_emb, dev, f32))
    non_text = _projector(feats["entity_proj"], feats["non_text_entity_emb"][None, :])[0]
    ent = torch.where(_as(nontext_mask, dev, torch.bool)[:, None], non_text[None, :], ent)
    rel = _projector(feats["relation_proj"], _as(relation_emb, dev, f32))
    return TripleIndex(
        head_repr=ent[_as(heads, dev, torch.long)],
        rel_repr=rel[_as(rels, dev, torch.long)],
        tail_repr=ent[_as(tails, dev, torch.long)],
        struct_raw=_as(struct_raw, dev, f32),
    )


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


def _twin_scores(
    feats: dict[str, Any],
    gate: torch.Tensor,
    bias: torch.Tensor,
    h: torch.Tensor,
    r: torch.Tensor,
    t: torch.Tensor,
    struct_raw: torch.Tensor,
    *,
    bidirectional: bool,
    dtype: torch.dtype,
) -> torch.Tensor:
    """[..., C] scores: the forward view, or both views combined by the
    training-time twin-view softmax."""
    fwd = _score_chunk(feats, gate, bias, h, r, t, struct_raw, dtype=dtype)
    if not bidirectional:
        return fwd
    s_dim = struct_raw.shape[-1] // 2
    s_swap = torch.cat([struct_raw[..., s_dim:], struct_raw[..., :s_dim]], dim=-1)
    bwd = _score_chunk(feats, gate, bias, t, r, h, s_swap, dtype=dtype)
    stacked = torch.stack([fwd, bwd])
    return (torch.softmax(stacked, dim=0) * stacked).sum(dim=0)


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
    _, gate, bias = _query_context(feats, q_emb)
    scores = _twin_scores(feats, gate, bias, head_repr, rel_repr, tail_repr, struct_raw,
                          bidirectional=True, dtype=dtype)
    scores = torch.where(edge_valid.bool(), scores, torch.full_like(scores, float("-inf")))
    return topk_desc(scores, k)


def _pooled_setup(bundle, q_emb, index, device):
    dev = resolve_device(device)
    feats = tree_to(bundle["features"], dev)
    _, gate, bias = _query_context(feats, _as(q_emb, dev, torch.float32))
    return feats, gate, bias, index.to(dev)


@torch.inference_mode()
def query_topk(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,    # [B, D] raw question embeddings
    index: TripleIndex,
    *,
    k: int,
    chunk: int = 2048,
    bidirectional: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates per query: ([B, k] f32 scores, [B, k] int32 ids).

    Streams the candidate axis in ``chunk``-sized slices with a running
    top-k merge, ordered (score desc, index asc); unfilled slots (k > M)
    are -inf with id -1.  ``bidirectional`` reproduces the training-time
    twin-view softmax combine.  Runs on ``device`` (cuda unless ``"cpu"``).
    """
    feats, gate, bias, idx = _pooled_setup(bundle, q_emb, index, device)
    b, dev = gate.shape[0], gate.device
    top_v = torch.full((b, k), float("-inf"), device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, idx.num_candidates, chunk):
        sl = slice(c0, c0 + chunk)
        scores = _twin_scores(feats, gate, bias, idx.head_repr[sl], idx.rel_repr[sl], idx.tail_repr[sl],
                              idx.struct_raw[sl], bidirectional=bidirectional, dtype=dtype)
        ids = torch.arange(c0, c0 + scores.shape[1], dtype=torch.int32, device=dev)
        top_v, pos = topk_desc(torch.cat([top_v, scores], dim=1), k)
        top_i = torch.take_along_dim(torch.cat([top_i, ids.expand(b, -1)], dim=1), pos.long(), dim=1)
    return top_v, top_i


@torch.inference_mode()
def score_all(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,
    index: TripleIndex,
    *,
    chunk: int = 2048,
    bidirectional: bool = True,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """[B, M] dense f32 scores (for parity tests / recall evaluation),
    computed ``chunk`` candidates at a time."""
    feats, gate, bias, idx = _pooled_setup(bundle, q_emb, index, device)
    return torch.cat([
        _twin_scores(feats, gate, bias, idx.head_repr[c0:c0 + chunk], idx.rel_repr[c0:c0 + chunk],
                     idx.tail_repr[c0:c0 + chunk], idx.struct_raw[c0:c0 + chunk],
                     bidirectional=bidirectional, dtype=dtype)
        for c0 in range(0, idx.num_candidates, chunk)
    ], dim=1)
