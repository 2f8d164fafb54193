"""Frozen-retriever feature embedder for the GFlowNet.

Counterpart of ``evi_rag_tpu/models/gflownet/embedder.py``.  The retriever's
feature bundle (``train/checkpoint.py::export_retriever_features``, tensors
as ``bundle_from_numpy`` makes them) is applied as plain functions:

* node tokens = entity_proj(entity text emb), the non-text rows replaced by
  the projected learned embedding;
* question tokens = query_proj(question emb);
* edge tokens = the mean over (fwd, bwd) of the retriever's state_net
  features -- DistMult x nav gate | struct ctx | TransE error | dist -- over
  DDE struct features rebuilt from the start nodes with the bundle's
  ``parity_meta`` rounds (``geometry``, ``state_net_0`` through
  ``ops.nnfn.dense_split`` at f32), or the legacy ``concat`` adapter;
* plus the trainable zero-init ``edge_score_proj(score)`` bonus
  (``apply_score_bonus``), the only part with parameters.

``embed_agent_batch_frozen`` has no trainable input, so it runs without
autograd, and a caller may compute it once per batch and reuse it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from evi_rag_tpu_torch.models.batches import AgentBatch
from evi_rag_tpu_torch.models.dde import build_node_struct_features
from evi_rag_tpu_torch.ops.nnfn import dense, dense_split, gelu_exact, layernorm, projector


@dataclasses.dataclass(frozen=True)
class EmbedOutputs:
    edge_tokens: torch.Tensor      # [E, H]
    node_tokens: torch.Tensor      # [N, H]
    question_tokens: torch.Tensor  # [G, H]


def _geometry_features(
    feats: Any,
    *,
    q_edge: torch.Tensor,
    head_edge: torch.Tensor,
    relation_edge: torch.Tensor,
    tail_edge: torch.Tensor,
    struct_edge: torch.Tensor,
) -> torch.Tensor:
    """The retriever's pre-score-head feature stack, at f32."""
    r_ctx = relation_edge * torch.sigmoid(dense(feats["q_gate"], q_edge)) + torch.tanh(dense(feats["q_bias"], q_edge))
    struct_ctx = gelu_exact(layernorm(feats["struct_norm"], dense(feats["struct_proj"], struct_edge)))
    nav_gate = torch.sigmoid(dense(feats["struct_gate"], struct_ctx))
    interaction = head_edge * r_ctx * tail_edge * nav_gate
    error_vec = head_edge + r_ctx - tail_edge
    dist = -torch.sqrt(torch.sum(error_vec * error_vec, dim=-1, keepdim=True) + 1e-12)
    h = gelu_exact(layernorm(
        feats["state_norm"],
        dense_split(feats["state_net_0"], (interaction, struct_ctx, error_vec, dist), torch.float32),
    ))
    return dense(feats["state_net_1"], h)


def _adapter_features(
    adapter: Any,
    *,
    q_edge: torch.Tensor,
    head_edge: torch.Tensor,
    relation_edge: torch.Tensor,
    tail_edge: torch.Tensor,
    struct_edge: torch.Tensor,
) -> torch.Tensor:
    """Legacy concat-mode edge adapter: Linear -> LN -> GELU -> Linear over
    [q | h | r | t | struct], as split matmuls (the concat is never built)."""
    w = adapter["dense_0"]["kernel"]
    h = q_edge.shape[-1]
    s = struct_edge.shape[-1]
    if w.shape[0] != 4 * h + s:
        raise ValueError(f"edge_adapter in_dim {w.shape[0]} != 4*{h}+{s} (semantic + struct)")
    z = (q_edge @ w[:h] + head_edge @ w[h : 2 * h] + relation_edge @ w[2 * h : 3 * h]
         + tail_edge @ w[3 * h : 4 * h] + struct_edge @ w[4 * h :] + adapter["dense_0"]["bias"])
    z = gelu_exact(layernorm(adapter["norm"], z))
    return dense(adapter["dense_1"], z)


@torch.no_grad()
def embed_agent_batch_frozen(bundle: dict[str, Any], batch: AgentBatch) -> EmbedOutputs:
    """(edge, node, question) tokens from the frozen retriever bundle,
    without the trainable edge-score bonus.  ``batch`` must be dense (see
    ``models.batches.materialize_agent_batch``) and on the bundle's device."""
    feats = bundle["features"]
    parity = bundle["parity_meta"]
    gb = batch.graph

    question_tokens = projector(feats["query_proj"], batch.question_emb)
    node_tokens = projector(feats["entity_proj"], batch.node_emb)
    non_text = projector(feats["entity_proj"], feats["non_text_entity_emb"][None, :])[0]
    node_tokens = torch.where(batch.node_is_nontext[:, None], non_text[None, :], node_tokens)
    relation_tokens = projector(feats["relation_proj"], batch.edge_emb)

    if int(parity["num_topics"]) != 2:
        raise ValueError("parity_meta.num_topics must be 2")
    one = batch.node_is_start.to(torch.float32)
    node_struct = build_node_struct_features(
        torch.stack([1.0 - one, one], dim=-1), gb.edge_index,
        num_rounds=int(parity["dde_rounds"]), num_reverse_rounds=int(parity["dde_reverse_rounds"]),
        edge_mask=gb.edge_mask,
    )
    heads, tails = gb.heads.long(), gb.tails.long()
    struct_fwd = torch.cat([node_struct[heads], node_struct[tails]], dim=-1)
    struct_bwd = torch.cat([node_struct[tails], node_struct[heads]], dim=-1)

    q_edge = question_tokens[gb.edge_batch.long()]
    head_edge, tail_edge = node_tokens[heads], node_tokens[tails]
    edge_mode = bundle.get("edge_mode", "geometry")
    if edge_mode == "concat":
        fn, params = _adapter_features, feats["edge_adapter"]
    elif edge_mode == "geometry":
        fn, params = _geometry_features, feats
    else:
        raise ValueError(f"unknown edge_mode {edge_mode!r}")
    fwd = fn(params, q_edge=q_edge, head_edge=head_edge, relation_edge=relation_tokens,
             tail_edge=tail_edge, struct_edge=struct_fwd)
    bwd = fn(params, q_edge=q_edge, head_edge=tail_edge, relation_edge=relation_tokens,
             tail_edge=head_edge, struct_edge=struct_bwd)
    return EmbedOutputs(edge_tokens=0.5 * (fwd + bwd), node_tokens=node_tokens, question_tokens=question_tokens)


def apply_score_bonus(embed: EmbedOutputs, batch: AgentBatch, edge_score_proj: Any) -> EmbedOutputs:
    """Add the trainable zero-init Linear(1, H) retriever-score bonus to the
    edge tokens (``edge_score_proj``: ``{"kernel": [1, H], "bias": [H]}``)."""
    score_in = batch.edge_scores.to(embed.edge_tokens.dtype)[:, None]
    return dataclasses.replace(embed, edge_tokens=embed.edge_tokens + dense(edge_score_proj, score_in))


def embed_agent_batch(bundle: dict[str, Any], batch: AgentBatch, *, edge_score_proj: Any) -> EmbedOutputs:
    """Frozen embedding + trainable edge-score bonus in one call."""
    return apply_score_bonus(embed_agent_batch_frozen(bundle, batch), batch, edge_score_proj)


def init_edge_score_proj(hidden_dim: int, *, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Zero-init Linear(1, H): the score bonus starts neutral."""
    return {"kernel": torch.zeros(1, hidden_dim, device=device), "bias": torch.zeros(hidden_dim, device=device)}
